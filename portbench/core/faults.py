"""Faults planted in the port's transition, for the check's own tests and
for reading each fault's numbers on the chip (``control.py``): the NUTS
tree (``inference/nuts_batched.LockstepTree``), which every sampler's
transition calls, returns

- ``unchanged``: every chain's state as it came in;
- ``half``: the second half of the chains as they came in (left out);
- ``altered``: chain 0's new position moved by 0.1 in every coordinate,
  its log-density and gradient those of the position before the move.

A cell on one chip has no exchange between chips to leave out."""
from __future__ import annotations

import contextlib
import importlib

from .sampler import PKG

KINDS = ("unchanged", "half", "altered")


def _broken(call, kind):
    def tree_call(self, q, logp, grad, step_size, metric):
        out = call(self, q, logp, grad, step_size, metric)
        q1, lp1, g1, stats = out[:4]
        if kind == "unchanged":
            q1, lp1, g1 = q.clone(), logp.clone(), grad.clone()
        elif kind == "half":
            h = q.shape[0] // 2
            q1, lp1, g1 = q1.clone(), lp1.clone(), g1.clone()
            q1[h:], lp1[h:], g1[h:] = q[h:], logp[h:], grad[h:]
        elif kind == "altered":
            q1 = q1.clone()
            q1[0] += 0.1
        return (q1, lp1, g1, stats, *out[4:])
    return tree_call


@contextlib.contextmanager
def planted(kind: str):
    """Inside the context the port's tree has the fault ``kind``."""
    if kind not in KINDS:
        raise ValueError(f"unknown fault {kind!r}; one of {KINDS}")
    tree = importlib.import_module(f"{PKG}.inference.nuts_batched").LockstepTree
    call = tree.__call__
    tree.__call__ = _broken(call, kind)
    try:
        yield
    finally:
        tree.__call__ = call
