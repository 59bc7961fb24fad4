"""The check that decides ``correct``, on what the window and set-up
produced.

The reference (``portbench/reference``) rebuilds the posterior from the
benchmark's data and the configuration, in float64: phi (the configuration's
own where it gives one, else the reference's own GP smoothing,
``reference/nlml.py``), the GP operators, the band and its widening, the
ODE, the transforms. From the program it reads the coordinates the sampler
ran in (the whitener's W and center, its metric and step sizes, its random
numbers): state that any valid sampler may choose, which the reference
follows rather than re-derives. The momentum factor it works out itself
from the metric's M^-1. What set-up chose is judged by two numbers of its
own: the phi (``nlml_gap``) and the step sizes (``accept_shortfall``).

Numbers compared (a cell compares those its ``cells/<workload>.json``
limits):

- ``lp_gap``: the widest gap, in nats, between the log-density the program
  returned with a draw and the reference's at that draw, over every chain
  of the kept transitions (the window's last one among them);
- ``grad_gap``: the widest relative gap between their gradients there;
- ``step_mismatch``: the share of the kept transitions' chains whose draw
  is not the one the reference makes from the same start with the same
  random numbers (``reference.nuts.moved_apart``);
- ``band_gap``: the band the program used less the reference's (exact);
- ``nlml_gap``: where the configuration leaves phi to the data, the
  reference's GP objective at the program's phi (the noise re-fitted) less
  its minimum, summed over the dimensions (nats);
- ``accept_shortfall``: the recipe's target acceptance less the mean
  acceptance statistic of the reference's re-run transitions, taken with
  the program's step sizes and metric: how far below its target set-up's
  adaptation left the sampler.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..reference import nlml as ref_nlml
from ..reference import nuts as ref_nuts
from ..reference.posterior import Posterior, Tempered, Whitened


class State(NamedTuple):
    """What the check takes from a run, on the host, float64 where real."""

    kept: list            # sampler.Kept with host arrays
    eps: np.ndarray       # (C,)
    metric: tuple         # ("dense", minv (dim, dim)), ("rung", (K, dim, dim)), ("diag", (C, dim))
    w: np.ndarray         # (dim, dim) or None
    center: np.ndarray    # (dim,) or None
    inv_temps: np.ndarray  # (K,) or None
    phi: np.ndarray
    band: int
    rng_device: str
    draw_dtype: torch.dtype
    max_depth: int


def host(t):
    return t.detach().to("cpu", torch.float64).numpy() if isinstance(t, torch.Tensor) else t


def capture(driver, window, result) -> State:
    """Copy to the host what the check needs, so the program's state can
    be freed before the reference runs."""
    from .sampler import Kept, TemperingDriver

    kept = [Kept(k.index, k.rng_state.clone(), k.mult, tuple(host(a) for a in k.before),
                 tuple(host(a) for a in k.after), k.doublings, k.parity) for k in window.kept]
    m = driver.metric
    if isinstance(driver, TemperingDriver):
        metric, inv_temps = ("rung", host(m.minv)), host(driver.carry.inv_temps)
    else:
        inv_temps = None
        metric = ("dense", host(m.minv)) if driver.dense else ("diag", host(m.inv_mass))
    wh = driver.whitener
    eps = driver.eps if isinstance(driver, TemperingDriver) else driver.carry.eps
    return State(kept, eps.detach().cpu().numpy(), metric,
                 None if wh is None else host(wh.W), None if wh is None else host(wh.center),
                 inv_temps, np.asarray(result.phi, np.float64),
                 int(result.diagnostics["bandsize"]), driver.generator.device.type,
                 driver.dtype, driver.tree.max_depth)


class Fit(NamedTuple):
    """The reference's phi (2, D) and, where it fitted phi to the data, the
    per-dimension minima of its GP objective (else None)."""

    phi: np.ndarray
    best: Optional[np.ndarray]


def fit(cell, y, t) -> Fit:
    p = cell.config["problem"]
    if p.get("phi") is not None:
        return Fit(np.asarray(p["phi"], np.float64), None)
    phi, best = ref_nlml.fit(t, y, float(p["jitter"]))
    return Fit(phi, best)


def posterior(cell, y, t, phi) -> Posterior:
    p, recipe = cell.config["problem"], cell.traffic["recipe"]
    return Posterior(
        system=p["system"], y=y, t=t, phi=phi,
        sigma=None if p.get("sigma") is None else np.asarray(p["sigma"], np.float64),
        prior_temperature=tuple(recipe.get("prior_temperature", (1.0, 1.0, 1.0))),
        theta_lower=np.asarray(p["theta_lower"], np.float64),
        theta_constrained=bool(recipe.get("theta_constrained", False)),
        bandsize=int(p["band_size"]), jitter=float(p["jitter"]))


@contextlib.contextmanager
def tf32(on: bool):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


class Side:
    """The reference's arithmetic in one precision: float64, or the
    control's float32 with TF32 products."""

    def __init__(self, post: Posterior, st: State, device, dtype):
        self.st, self.device, self.dtype = st, device, dtype
        put = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
        self.put = put
        self.vg = (post.value_and_grad if st.w is None
                   else Whitened(post, put(st.w), put(st.center)))
        kind, m = st.metric
        self.metric = ref_nuts.Diagonal(put(m)) if kind == "diag" else ref_nuts.Dense(put(m))
        self.beta = None
        if st.inv_temps is not None:
            self.beta = put(np.tile(st.inv_temps, st.eps.shape[0] // st.inv_temps.shape[0]))

    def value_and_grad(self, q):
        return self.vg(self.put(q))

    def transition(self, k):
        """The kept transition k from its start: (q (C, dim), the NUTS
        transition's acceptance statistic (C,))."""
        st, put = self.st, self.put
        c, dim = k.before[0].shape
        draws = ref_nuts.GeneratorDraws(k.rng_state, st.rng_device, st.draw_dtype, c, dim,
                                        self.dtype)
        eps = (torch.as_tensor(st.eps, dtype=st.draw_dtype) * k.mult).to(self.dtype)
        q0 = put(k.before[0])
        vg = self.vg if self.beta is None else Tempered(self.vg, self.beta)
        lp0, g0 = vg(q0)
        res = ref_nuts.transition(vg, q0, lp0, g0, eps.to(self.device), self.metric, draws,
                                  st.max_depth)
        if self.beta is None:
            return res.q, res.accept
        kk = st.inv_temps.shape[0]
        swap = ref_nuts.GeneratorDraws(k.rng_state, st.rng_device, st.draw_dtype, c, dim,
                                       self.dtype)
        swap.momentum()
        for i in range(k.doublings):
            swap.doubling(i)
        u = swap.swap(c // kk, kk).to(self.device)
        q, _, _ = ref_nuts.swap_sweep(res.q.view(-1, kk, dim), (res.logp / self.beta).view(-1, kk),
                                      (res.grad / self.beta[:, None]).view(-1, kk, dim),
                                      put(st.inv_temps), u, k.parity)
        return q.reshape(c, dim), res.accept


def _gaps(lp, g, lp_ref, g_ref):
    lp_gap = float(torch.max(torch.abs(lp - lp_ref)))
    rel = torch.linalg.vector_norm(g - g_ref, dim=-1) / torch.linalg.vector_norm(g_ref, dim=-1)
    return lp_gap, float(torch.max(rel))


def readings(post: Posterior, st: State, device, target: float, ref_fit: Fit, data,
             control: bool = False) -> dict:
    """The numbers compared, of the program's outputs, or with ``control``
    of the control's: the reference in float32 with TF32 products put in the
    program's place, on the same positions, starts and random numbers, and
    its GP smoothing in float32 in place of the program's NLML. ``data`` is
    (y, t, jitter) where phi was fitted to the data."""
    ref = Side(post, st, device, torch.float64)
    alt = Side(post, st, device, torch.float32) if control else None
    lp_gap = grad_gap = 0.0
    mismatched = total = 0
    accept = []
    for k in st.kept:
        q1, lp1, g1 = (ref.put(a) for a in k.after)
        lp_ref, g_ref = ref.value_and_grad(q1)
        if control:
            with tf32(True):
                lp1, g1 = alt.value_and_grad(q1)
            lp1, g1 = lp1.double(), g1.double()
        gaps = _gaps(lp1, g1, lp_ref, g_ref)
        lp_gap, grad_gap = max(lp_gap, gaps[0]), max(grad_gap, gaps[1])
        q_ref, acc = ref.transition(k)
        if control:
            with tf32(True):
                q1, acc = alt.transition(k)
            q1, acc = q1.double(), acc.double()
        accept.append(acc)
        miss = ref_nuts.moved_apart(q1, q_ref, ref.put(k.before[0]))
        mismatched += int(miss.sum())
        total += int(miss.numel())
    out = {"lp_gap": lp_gap, "grad_gap": grad_gap,
           "step_mismatch": mismatched / max(total, 1),
           "band_gap": float(abs(st.band - post.band)),
           "accept_shortfall": target - float(torch.cat(accept).mean())}
    if ref_fit.best is not None:
        y, t, jitter = data
        phi = ref_nlml.fit(t, y, jitter, torch.float32)[0] if control else st.phi
        out["nlml_gap"] = float(ref_nlml.gap(phi, t, y, jitter, ref_fit.best).sum())
    return out


def check(cell, y, t, st: State, device, control: bool = False,
          ref_fit: Optional[Fit] = None) -> dict:
    """The reference worked out from the data (phi, unless ``ref_fit``
    gives it; the posterior) and the numbers of ``readings``."""
    ref_fit = ref_fit or fit(cell, y, t)
    post = posterior(cell, y, t, ref_fit.phi)
    target = float(cell.traffic["recipe"]["target_accept_ratio"])
    return readings(post, st, device, target, ref_fit,
                    (y, t, float(cell.config["problem"]["jitter"])), control)


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number the cell compares (those with a limit) finite and
    within its limit."""
    return all(np.isfinite(numbers[name]) and numbers[name] <= limit
               for name, limit in limits.items())
