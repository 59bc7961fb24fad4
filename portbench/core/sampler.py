"""Driving the port, the system under test.

Set-up is the port's own pipeline, ``solve_magi`` as a user calls it, with
the cell's recipe (its traffic mix) cut to the warmup the mix names and one
sampling draw, writing its sampling checkpoint: data, NLML, MAP, Gauss-
Newton, whitener and warmup. It runs with the mix's ``setup_seed``, so that
every run of a cell samples from the same adapted state (step sizes,
metric, whitener, positions) and does the same work; ``--seed`` seeds the
window's own random numbers (momenta, the tree's uniforms, the step-size
jitter). The window then continues that run from the checkpoint as
``parallel/chains._sample`` and ``inference/tempering._pt_sample`` do: the value-and-grad replayed from a CUDA graph, one
``LockstepTree`` whose every depth is captured before the window, the
sampling transition of ``make_sample_step_batched`` (NUTS) or one parallel-
tempering iteration (``tempering._pt_step``: the batched transition of all
rungs, then the swap sweep), each chunk's draws copied to the host.

The port is imported here and in nothing else of the yardstick.
"""
from __future__ import annotations

import importlib
from typing import NamedTuple

import numpy as np
import torch

PKG = "manifold_constrained_gaussian_process_inference_tpu_torch"
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def port():
    return importlib.import_module(PKG)


def _mod(name: str):
    return importlib.import_module(f"{PKG}.{name}")


def magi_config(cell, device: str, checkpoint_path: str):
    """The recipe's MagiConfig: the configuration's problem, the traffic
    mix's sampler settings and set-up seed, ``warmup`` iterations of warmup
    and one draw."""
    problem, recipe = cell.config["problem"], cell.traffic["recipe"]
    warmup = int(cell.traffic["warmup"])
    kw = dict(recipe)
    for key in ("kernel", "band_size", "jitter"):
        kw[key] = problem[key]
    for key in ("phi", "sigma"):
        if problem.get(key) is not None:
            kw[key] = np.asarray(problem[key], dtype=np.float64)
    dtype = DTYPES[cell.config["dtype"]] if device != "cpu" else torch.float64
    return port().MagiConfig(
        niter_hmc=warmup + 1, burnin_ratio=(warmup + 0.5) / (warmup + 1),
        seed=int(cell.traffic["setup_seed"]),
        device=device, dtype=dtype, checkpoint_path=checkpoint_path, **kw)


class Kept(NamedTuple):
    """A transition the check re-runs: its index, the generator's state and
    the step-size multiplier before it, the chains' state before and after
    it (q, logp, grad), the doublings it ran and, for a ladder, the sweep's
    parity."""

    index: int
    rng_state: torch.Tensor
    mult: float
    before: tuple
    after: tuple
    doublings: int
    parity: int


class Driver:
    """The window's transitions on the state that set-up left. Subclasses
    set ``vg`` (the sampler's value-and-grad), ``tree``, ``generator``,
    ``metric`` and the carry, and implement ``state`` and ``advance``."""

    whitener = None
    step_jitter = 0.0

    def __init__(self, result, device, seed):
        d = result.diagnostics
        self.seed = int(seed)
        self.device = torch.device(device)
        self.target, self.whitener = d["target"], d["whitener"]
        whiten = _mod("inference.whiten")
        self.vg_plain = (whiten.make_centered_whitened_vg(self.target, self.whitener)
                         if self.whitener is not None else self.target.value_and_grad_fn())
        self.route = d["vg_route"]
        self.dtype = DTYPES[d["dtype"].replace("torch.", "")]

    def put(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.device)

    def graphed(self, vg, example):
        if self.device.type != "cuda":
            return vg
        return _mod("parallel.chains").GraphedValueAndGrad(vg, example)

    def capture_all(self, q, eps, metric):
        """Every depth of the tree captured now, so that nothing is captured
        inside the window. The captures run no kernel and draw nothing."""
        if not self.tree.graphed:
            return
        bound = self.tree._bind(q, eps, metric)
        for i in range(self.tree.max_depth):
            if i not in self.tree.graphs:
                self.tree.graphs[i] = self.tree._capture(bound, i)
        torch.cuda.synchronize(self.device)

    def mults(self, length: int):
        """Step-size multipliers of a chunk (``step_jitter``), or Nones."""
        if not self.step_jitter:
            return [None] * length
        chains = _mod("parallel.chains")
        return [float(m) for m in chains.jitter_multipliers(
            self.jitter_rng, length, self.step_jitter, self.step_jitter_low)]


class NutsDriver(Driver):
    """NUTS chains under a pooled dense or per-chain diagonal metric."""

    def __init__(self, result, ckpt_path, device, max_depth, seed):
        super().__init__(result, device, seed)
        ckio, nuts = _mod("inference.checkpoint"), _mod("inference.nuts")
        chains, nb = _mod("parallel.chains"), _mod("inference.nuts_batched")
        ck = ckio.load_checkpoint(ckpt_path)
        meta, state = ck.meta or {}, ck.state or {}
        q = self.put(ck.psi)
        self.dense = meta.get("metric") == "dense-pooled"
        if self.dense:
            self.metric = nuts.DenseMetric(*chains.dense_metric_from_minv(
                ck.inv_mass, self.dtype, self.device, state["metric_chol"], state["metric_pchol"]))
            self.step_jitter = float(meta.get("step_jitter") or 0.0)
            self.step_jitter_low = float(meta.get("step_jitter_low") or 0.4)
            self.jitter_rng = np.random.default_rng([self.seed, 2])
        else:
            self.metric = nuts.DiagMetric(self.put(ck.inv_mass))
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self.vg = self.graphed(self.vg_plain, q)
        self.tree = nb.LockstepTree(self.vg, self.generator, max_depth)
        self.step = nb.make_sample_step_batched(self.vg, max_depth, self.generator, None,
                                                self.tree)
        eps = self.put(ck.step_size)
        self.carry = nuts.SampleCarry(chain=nuts.ChainState(
            q=q, logp=self.put(state["logp"]), grad=self.put(state["grad"])), eps=eps)
        self.n_chains, self.dim = q.shape
        self.n_draws = self.n_chains
        self.capture_all(q, eps, self.metric)

    def state(self):
        c = self.carry.chain
        return c.q, c.logp, c.grad

    def advance(self, mult):
        self.carry, (q, logp, stats) = self.step(self.carry, mult, self.metric)
        return q, logp, stats, 0


class TemperingDriver(Driver):
    """Parallel tempering: R ladders of K rungs, one batched NUTS
    transition of all R K chains and one swap sweep per iteration; the
    cold rung of each ladder is a posterior chain."""

    def __init__(self, result, ckpt_path, device, max_depth, seed):
        super().__init__(result, device, seed)
        tt, nuts = _mod("inference.tempering"), _mod("inference.nuts")
        chains, nb = _mod("parallel.chains"), _mod("inference.nuts_batched")
        adapt = _mod("inference.adapt")
        ck = tt.load_pt_checkpoint(ckpt_path)
        qs_np = np.asarray(ck["qs"])
        self.n_rep = qs_np.shape[0] if qs_np.ndim == 3 else 1
        self.k, self.dim = qs_np.shape[-2:]
        self.n_chains = self.n_rep * self.k
        put = lambda a, *shape: self.put(np.asarray(a).reshape(*shape))  # noqa: E731
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        qs = put(qs_np, self.n_chains, self.dim)
        inv_temps = put(ck["inv_temps"], self.n_rep, self.k)[0].contiguous()
        self.beta = inv_temps.repeat(self.n_rep)
        self.vg_t, _ = tt._tempered_vg(self.vg_plain, self.beta, qs)
        self.vg = self.vg_t
        self.metric = nuts.RungDenseMetric(*chains.dense_metric_from_minv(
            ck["metric_minv"], self.dtype, self.device, ck["metric_chol"], ck["metric_pchol"]))
        self.eps = put(ck["eps"], self.n_chains)
        counters = lambda name: torch.as_tensor(  # noqa: E731
            np.asarray(ck[name]).reshape(self.n_rep, self.k), dtype=torch.int32,
            device=self.device)
        self.carry = tt.PTCarry(
            qs=qs, lp=put(ck["lp"], self.n_chains), grads=put(ck["grads"], self.n_chains, self.dim),
            da=adapt.da_init(self.eps), welford=adapt.welford_init(
                self.dim, self.dtype, self.device, batch=(self.n_chains,)),
            inv_mass=put(ck["inv_mass"], self.n_chains, self.dim), inv_temps=inv_temps,
            n_swap_accept=counters("n_swap_accept"), n_swap_try=counters("n_swap_try"),
            iteration=int(np.asarray(ck["iteration"]).reshape(self.n_rep)[0]))
        self.tree = nb.LockstepTree(self.vg_t, self.generator, max_depth)
        self.max_depth = max_depth
        self._pt_step = tt._pt_step
        self.n_draws = self.n_rep
        self.capture_all(qs, self.eps, self.metric)

    def state(self):
        return self.carry.qs, self.carry.lp, self.carry.grads

    def advance(self, mult):
        parity = self.carry.iteration
        self.carry, stats, _ = self._pt_step(self.vg_t, self.beta, self.carry, self.eps,
                                             self.metric, self.generator, self.max_depth,
                                             None, self.tree)
        cold = lambda t: t.view(self.n_rep, self.k, *t.shape[1:])[:, 0]  # noqa: E731
        return cold(self.carry.qs), cold(self.carry.lp), stats, parity


DRIVERS = {"nuts": NutsDriver, "pt-nuts": TemperingDriver}


def set_up(cell, y, t, seed: int, device: str, ckpt_path: str):
    """solve_magi through the recipe's warmup and one draw, then the driver
    of the window, seeded with ``seed``, on the state it left. Returns
    (driver, result)."""
    mt = port()
    config = magi_config(cell, device, ckpt_path)
    result = mt.solve_magi(y, t, mt.get_system(cell.config["problem"]["system"]), config)
    driver = DRIVERS[config.sampler](result, ckpt_path, device, config.max_tree_depth, seed)
    return driver, result
