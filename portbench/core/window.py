"""The measured window: the driver's transitions for ``seconds`` of host
time, each chunk's draws copied to the host, the host clock read once per
transition, and a seed-drawn sample of transitions kept for the check.

A transition ends in the tree's own host read, so reading the clock after
it needs no synchronise; what the host enqueues after that read (the
draw's copies) runs under the next transition. The window closes at the
first transition that ends after ``seconds``, with the last chunk copied
and the device synchronised, and lasts from its first transition's start
to that point: every rate is over all the work and all the time of it.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .sampler import Kept

STATS = ("draws", "lp", "n_leapfrog", "depth", "diverging")


class Window:
    """What a window made: per transition its host seconds and batched
    leaves; per chain and transition the draws and the tree's statistics
    (host arrays, (chains, transitions, ...)); the kept transitions; the
    wall seconds."""

    def __init__(self):
        self.seconds, self.leaves, self.kept = [], [], []
        self.wall_s = 0.0
        self.chunks = {key: [] for key in STATS}

    @property
    def transitions(self) -> int:
        return len(self.seconds)

    def __getattr__(self, key):
        if key in STATS:
            return np.concatenate(self.chunks[key], axis=1)
        raise AttributeError(key)


def run(driver, seconds: float, chunk: int, n_kept: int, rng: np.random.Generator) -> Window:
    """Drive the window. ``n_kept`` transitions are kept for the check: the
    last and, by reservoir sampling with ``rng`` (Algorithm R), n_kept - 1
    of the others, each as likely as any other whatever the window's
    length."""
    w = Window()
    sample, pending, seen = [], None, 0
    t0 = now = time.perf_counter()
    stop = t0 + seconds
    while now < stop:
        cols = {key: [] for key in STATS}
        for mult in driver.mults(chunk):
            rng_state = driver.generator.get_state()
            before = driver.state()
            q, lp, stats, parity = driver.advance(mult)
            end = time.perf_counter()
            w.seconds.append(end - now)
            now = end
            w.leaves.append(int(stats.lockstep_leaves))
            for key, value in zip(STATS, (q, lp, stats.num_leapfrog, stats.tree_depth,
                                          stats.diverging)):
                cols[key].append(value)
            if pending is not None:
                seen = _reservoir(sample, pending, seen, n_kept - 1, rng)
            pending = (w.transitions - 1, rng_state, 1.0 if mult is None else mult, before,
                       driver.state(), stats.tree_depth, parity)
            if now >= stop:
                break
        for key, col in cols.items():
            w.chunks[key].append(torch.stack(col, dim=1).cpu().numpy())
    if driver.device.type == "cuda":
        torch.cuda.synchronize(driver.device)
    w.wall_s = time.perf_counter() - t0
    for index, rng_state, mult, before, after, depth, parity in sorted(sample) + [pending]:
        w.kept.append(Kept(index, rng_state, mult, before, after, int(depth.max()), parity))
    return w


def _reservoir(sample, item, seen, k, rng):
    """Keep ``item`` in the k-slot reservoir ``sample`` with probability
    k / (seen + 1). Returns the items seen."""
    if k > 0:
        if len(sample) < k:
            sample.append(item)
        else:
            j = int(rng.integers(0, seen + 1))
            if j < k:
                sample[j] = item
    return seen + 1
