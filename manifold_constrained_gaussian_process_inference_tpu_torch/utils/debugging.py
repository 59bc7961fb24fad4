"""Non-finite guards for a value-and-grad (port of the JAX package's
utils/debugging.py).

``nan_guard`` counts the chains whose log-density or gradient is not
finite, on the device, and passes the values through unchanged (NUTS
already treats a non-finite value as a divergence). It reads nothing on
the host per call, so it runs inside a captured CUDA graph; the count is
read, and reported, when asked for. ``checkify_value_and_grad`` returns
the checks with the values, for tests and debugging: ``err.get()`` is None
or the message, ``err.throw()`` raises it.
"""
from __future__ import annotations

import logging
from typing import Callable, Optional

import torch

logger = logging.getLogger(__name__)


def _bad_chains(value: torch.Tensor, grad: torch.Tensor):
    """(chains with a non-finite value, chains with a non-finite gradient
    entry) of one evaluation, as device booleans shaped like ``value``."""
    bad_g = ~torch.isfinite(grad)
    if grad.dim() > value.dim():
        bad_g = bad_g.any(dim=-1)
    return ~torch.isfinite(value), bad_g


class NanGuard:
    """``vg`` with device-side counts of non-finite evaluations: chains
    whose value or gradient is not finite, and non-finite gradient entries
    (``report()``'s ``n_bad`` and ``n_bad_grad``). The buffers are made at the first
    call, so capture a CUDA graph after one eager call (as the sampler's
    warm-up calls do); a replay adds to them in place."""

    def __init__(self, vg: Callable, name: str = "logdensity"):
        self.vg = vg
        self.name = name
        self.counts: Optional[torch.Tensor] = None  # (2,) int64: bad chains, bad entries

    def __call__(self, psi):
        value, grad = self.vg(psi)
        if self.counts is None:
            self.counts = torch.zeros(2, dtype=torch.int64, device=value.device)
        bad_v, bad_g = _bad_chains(value, grad)
        self.counts += torch.stack([(bad_v | bad_g).sum(), (~torch.isfinite(grad)).sum()])
        return value, grad

    def report(self) -> dict:
        """Read the counts (one host read), logging a warning when any is
        not zero."""
        n_bad, n_bad_grad = (0, 0) if self.counts is None else self.counts.tolist()
        if n_bad:
            logger.warning("[nan-guard:%s] non-finite: %d evaluation(s), %d gradient entries",
                           self.name, n_bad, n_bad_grad)
        return {"n_bad": n_bad, "n_bad_grad": n_bad_grad}


def nan_guard(vg: Callable, name: str = "logdensity") -> NanGuard:
    """Wrap a psi -> (value, grad) function with non-finite counting."""
    return NanGuard(vg, name)


class CheckError:
    """The checks of one evaluation, kept on the device until read: the
    JAX package's checkify error (``get``, ``throw``)."""

    MESSAGES = ("non-finite log-density", "non-finite gradient entries")

    def __init__(self, failed: torch.Tensor):
        self.failed = failed  # (2,) bool: value check, gradient check

    def get(self) -> Optional[str]:
        hits = [m for m, bad in zip(self.MESSAGES, self.failed.tolist()) if bad]
        return "; ".join(hits) if hits else None

    def throw(self) -> None:
        msg = self.get()
        if msg is not None:
            raise FloatingPointError(msg)


def checkify_value_and_grad(vg: Callable):
    """psi -> (err, (value, grad)): ``err.get()`` is None when the value
    and every gradient entry are finite, else the failed checks' message;
    ``err.throw()`` raises it."""

    def checked(psi):
        value, grad = vg(psi)
        bad_v, bad_g = _bad_chains(value, grad)
        return CheckError(torch.stack([bad_v.any(), bad_g.any()])), (value, grad)

    return checked
