"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main paths with the likelihood on the band-storage
layout. A whitened FitzHugh-Nagumo value-and-grad ([slice], [chees],
[envelope], [mesh], [resume], [tree]'s [slice] and [envelope]) runs, between
its two whitening GEMMs, one launch of the hand-written kernel of
csrc/centered_vg.cu (its forward and analytic backward; route "kernel"),
the GEMMs themselves the hand-written product kernel of csrc/minv_mv.cu
on W and W^T, prepared once, where ``centered_vg.gemm_takes_kernel`` says
so ([slice], [chees], [envelope], [mesh]: 128, 64 and 32 chains);
every other gradient evaluation ([default], [families], [pt]'s log-Hes1,
[grid], [profile]) runs the hand-written CUDA band-matvec kernels K1: the
paired launch (mphi and GC^T on one input) and the single launch (GK^T)
forward, and their two launches backward (routes "raw" and "autograd"). Every
NUTS path runs its tree as CUDA graphs, one per doubling depth: leaves 0
and 1, then one WHILE node (csrc/graph_if.cu) whose body is one leaf pair,
run again while the condition that the commit kernel L2 sets holds (the
JAX package's leaf loop on the device); each path line prints its host
reads per transition, at most the transition's doublings + 1. Every leaf
of every NUTS tree runs the hand-written kernels of csrc/nuts_leaf.cu
around its value-and-grad (the JAX package's fused leaf body, with the leaf
counter on the device): L2 the commit, which also drifts the next leaf;
each doubling opens with D1 (the direction, the edge, the sub-tree's reset
and leaf 0's position) and ends with D2 (the merge into the trajectory and
the readout the host reads); under a dense metric the leaf's
product M^-1 g is the hand-written kernel of csrc/minv_mv.cu, on an operand
its preparation kernel writes when the tree's metric changes. The paths: the production ``solve_magi`` (128 NUTS chains under a pooled dense
metric, exact-Hessian whitening, mode-centered float32 evaluation) and the
default ``solve_magi`` (one chain, the diagonal Welford metric, raw Psi) on
the FitzHugh-Nagumo workload (n=397, D=2); parallel-tempering NUTS on
log-Hes1 with H never observed; ChEES-HMC under SNAPER on the FN workload.
Phases:

1. device: the card's name and power limit; TF32 must be off;
2. build: compile the kernels from csrc/ with nvcc;
3. likelihood: the whitened centered value-and-grad on the card, band
   (the kernel route: one centered_vg launch in its CUDA graph, no K1)
   against dense (autograd) in float32, both against a float64 CPU
   evaluation;
4. likelihood-3169: the same workload on the filllevel-5 grid (n=3169;
   the band escalates from 80 to 160), 128 chains, band against dense,
   eager and replayed from a CUDA graph; one chain against float64 on the
   CPU;
5. kernel: the single and paired kernels against their plain PyTorch
   versions at the main path's shape, at the n=3169 shape and at edge
   shapes (b = 0, n < 2b+1, b > 64), float64 and float32, forward and
   backward; each timed per launch from a CUDA graph of back-to-back
   calls beside its plain version and the dense torch.matmul. The kernel
   is also checked and timed at the shapes of the other paths: C = 1 (the
   default path, on the row tile; C = 5 is checked too, and C = 2 and 3
   at [grid]'s GK^T block) at both grids, [pt]'s (40 chains, D = 3,
   b = 20, n = 33) and [chees]'s (64 chains at the main shape). Each
   chain's outputs at C = 1, 2, 3 and the row tile's threshold's
   neighbours equal its rows of a 128-chain launch (the chain tile) bit
   for bit, in both dtypes, at both grids, the GK^T block and every edge;
5a. vg: the whitened FN value-and-grad's kernel against its plain
   version (ops/centered_vg.py) at the shapes of the paths it runs on:
   [slice]'s (128 chains, n = 397, b = 40), one chain, [chees]' 64, a
   [mesh] rank's 32, [resume]'s (8 chains, n = 41, sigma fixed, theta
   unbounded), config 4's (128 chains, n = 793, b = 80) and
   [likelihood-3169]'s (128 chains, n = 3169, b = 160):
   float64 within 1e-12 relative, float32 within twice the plain version's
   own error against float64; the same bars against the scalar cluster kernel
   (perf/baselines/centered_vg_pr12.cu, built beside it with the one-block
   kernel, perf/baselines/centered_vg_pr11.cu); a chain's bits the same at
   C = 1, 3 and 32 as in the whole launch; ms per launch (a replayed graph
   of 200) in both dtypes beside both earlier kernels, the bound and the
   plain version, with the tiling (cluster size S, slab L, chains a
   cluster Cg) and the prepared tiles' bytes read from L2, and the whole
   value-and-grad per replayed call on
   both routes, the kernel route also with its GEMMs on torch.matmul, and
   the float32 value-and-grad with its GEMMs on the product kernel no
   further from float64 (the autograd route's, which runs neither the
   product kernel nor centered_vg) than F32_VG_GEMM_FACTOR times with them
   on torch.matmul;
5b. graph-if: a WHILE node (csrc/graph_if.cu) against its plain version,
   the host loop: its body one kernel that advances a device counter and
   sets the condition counter < limit, the limit read from the device, so
   the replays run GRAPH_WHILE_ITERS iterations, then 0, 1 and 76 after the
   limit changes in place; timed per iteration;
5c. leaf: L2 against its plain version (ops/leaf.py) from the
   same inputs at every leaf of a depth-4 sub-tree, L2 in device-counter
   mode (the leaf index from the pair counter, as in the tree) and replayed
   from a CUDA graph, at [slice]'s shape (128 chains, dim 799, dense
   metric), [default]'s (one chain, a diagonal per chain), a shared
   diagonal (32 chains) and [pt]'s (40 chains, dim 105, one dense metric
   per rung), and at [grid]'s dim (6345: p_n, v_n and rho kept in shared
   memory) and a wider one (20000: kept in place), track_div_leaf on,
   float64 (1e-12) and float32 (1e-5; the energy sums to the energy's
   scale): the decisions (take, divergent, turned, alive) equal where no
   margin is within the tolerance (the flips within it printed), the state
   of the chains that agree, the pair counter, and on every odd leaf the
   condition L2 set, read through a WHILE node on its handle, equal to the
   plain version's (k < 2^4 / 2 and any chain alive); each chain's bits at
   C = 1, 3 and 32 equal to its rows of the 128-chain launch; the next
   leaf's q that L2 writes bit-equal to the plain drift of the state L2
   committed, for every chain (alive or not), at every shape; L2 and its
   plain version timed per launch from a CUDA graph of 200 launches,
   beside its bytes bound and its time before it drifted; the
   dense metric's product (csrc/minv_mv.cu) against the float64 plain
   version at [slice]'s, a [mesh] rank's, [resume]'s, one chain's and
   config 4's shapes: float64 within 1e-14 of the largest output, float32 no
   further than torch.matmul's float32 product, a chain's bits at C = 1, 3,
   32 as in the 128-chain launch, its prepared operand bit-equal to the
   preparation's plain version, no matmul in a dense metric's velocity on
   the card; timed beside torch.matmul, the first design's kernel
   (perf/baselines/minv_mv_pr13.cu, built beside it) and its operations
   bound, the preparation beside its plain version and bytes bound;
5d. doubling: D1 (the opening) and D2 (the merge) against their plain
   versions (ops/leaf.py) at [leaf]'s shapes, float64 and float32, track
   on and off, depths 0 and 3, every 5th chain done: D1's every buffer
   bit-equal, leaf 0's q the plain drift of the edge; D2 on a sub-tree end
   with divergent and turned chains, takes and a log_sum_w of -inf, every
   buffer bit-equal but the done flags, which may differ only where a row
   dot of the combined U-turn check is within rounding of 0, the readout's
   leaves 2k of the pair counter; a chain's bits at C = 1, 3 and 32 as in
   the 128-chain launch; each timed per launch from a CUDA graph of 200
   launches beside its plain version and bytes bound;
5e. tree: [slice]'s recipe, [default], [pt] and [envelope] at TREE_NITER
   iterations, each run twice through ``solve_magi``: on the graphed tree
   and on the eager tree (the CPU path, chosen by patching
   ``nuts_batched.tree_graphed``); draws, log-densities, every statistic,
   the step sizes, metric and the generator's final state bit for bit, the
   graphed run's host reads at most its doublings + 1 per transition, each
   run's D1 and D2 launches its doublings, L2's its batched leaves and the
   product's one per leaf and two per transition on [slice] and
   [envelope], plus two per value-and-grad for the whitening GEMMs, and
   the preparation's two for W and W^T and one per transition (the eager
   tree's at least one, at most one per transition; none of either on the
   other two); then
   every depth of a 128-chain [slice] tree captured up front: per depth the
   leaves captured (min(2^i, 4)), its WHILE node, capture seconds and MiB;
6. diag-gauss: the diag chain driver on the card at C = 4 on a
   799-dimensional independent Gaussian with scales log-spaced over
   [0.01, 10], trees capped at depth GAUSS_MAX_DEPTH: the draws' variances
   and the adapted inverse masses against the true scales;
7. default: ``solve_magi`` at the library's defaults on the FN example's
   workload (100 observations on [0, 20], noise 0.2, filllevel 2, sigma
   sampled; 200 iterations): the float32 value-and-grad of one chain at the
   start Psi against float64 on the CPU, finite draws, the sampling accept
   rate and divergences within their bars, and exactly 4 kernel launches
   per value-and-grad; per-leaf times and tree depths are printed;
8. families: the three model-family workloads of the JAX package's
   end-to-end tests (ptrans, hiv, hes1log_fixg; MAP warm start, theta
   constrained, gp_mean="observed") on the card in float32;
9. slice: the production ``solve_magi`` end to end; draws finite, recovery
   within the bars, and the kernel launches of this run (one centered_vg
   per value-and-grad, no K1);
10. pt: config 3 of docs/BENCHMARKS.md (log-Hes1 fixed-f, P and M observed
   in alternation, H never; n=33, D=3, dim=105; 10 rungs x 4 replicas =
   40 batched chains, pooled dense metric per rung, whitened, theta
   constrained, target accept 0.95, 3000 Adam steps of MAP warm start),
   cut to PT_NITER iterations: recovery, mixing and sampler-health bars,
   and the run's tempered value-and-grad, read after the ladder adapted,
   against the raw value times the final ladder (a CUDA graph reading a
   stale ladder fails it);
11. chees: config 7 (FN n=397, 64 chains, sigma fixed, phi from the NLML,
   whitened, SNAPER, target accept 0.95), CHEES_NITER iterations, each
   leapfrog step replayed from one CUDA graph: recovery, R-hat, trajectory
   length and health bars;
12. resume: short ``solve_magi`` runs on the card, each resumed through
   ``solve_magi(resume=...)`` from a checkpoint and its theta and lp held
   bit for bit against the uninterrupted run's: pooled dense NUTS killed
   mid-warmup, and NUTS, PT and ChEES after a sampling chunk;
13. mesh: MESH_RANKS ranks spawned by torch.multiprocessing over gloo, all
   on the one card (NCCL refuses two ranks on one card), the kernels built
   here before the spawn: (a) ``solve_magi(mesh=...)`` on [slice]'s recipe
   and data, 128 chains = 4 ranks x 32, cut to MESH_NITER iterations:
   recovery and divergence bars, exactly one centered_vg launch (no K1)
   per value-and-grad on every rank, and every rank's step sizes, metric and
   gathered result bit-identical; (b) the JAX package's dry-run protocol on
   the whitened target of (a): ``run_chains`` (128 chains, pooled),
   ``run_parallel_tempering`` (4 replicas) and ``run_chees`` (64 chains),
   each sharded against the same call unsharded, max |delta| < 1e-4 in
   float64 on the card (the float32 deltas are printed: there a batch's
   shape changes a chain's rounding, which a tree decision near its
   threshold turns into another trajectory); (c) a one-rank NCCL world (a
   subgroup of rank 0): (b)'s float32 ``run_chains`` bit-equal to the
   unsharded call;
14. resume-mesh: on the same ranks, [resume]'s runs sharded with
   ``solve_magi(mesh=...)`` (8 chains = 4 x 2, 4 PT replicas = 4 x 1, 16
   ChEES chains = 4 x 4): pooled NUTS killed mid-warmup and resumed under
   the mesh, bit-equal to the uninterrupted sharded run; diag NUTS, pooled
   PT and ChEES sampling checkpoints written by rank 0, the same on every
   rank (gathered carry, generator state), resumed unsharded on every rank
   to one result that equals a single-process resume from the same file,
   bit for bit (the checkpoint against the unsharded run's is printed);
15. grid: on the same ranks, the grid-sharded value-and-grad of
   [likelihood-3169]'s workload (n=3169, band 160, sigma sampled; the
   blocks built here in float64) at C = 1 and 128 against the unsharded
   banded value-and-grad on the card: in float64 under the JAX dry run's
   bars (value 1e-4 relative, gradient 1e-4 relative elementwise over
   |g| + 1e-3), in float32 the value alike and the gradient within 1e-4 of
   max |g|, and float32 against float64 on the CPU; the same on every rank,
   exactly 4 launches per value-and-grad eager and replayed; then NUTS on
   one chain on it;
16. envelope: [slice]'s recipe with ``divergence_envelope=True`` (step
   jitter off, as in the JAX package's envelope runs), ENVELOPE_NITER
   iterations of which ENVELOPE_ADAPTS warmup: the probes (exact float64
   Hessians on the host) collected after the first window end and folded
   at the second; at least one probe, 1 to 16 boosted directions per probe,
   a finite SPD folded metric, exactly one centered_vg launch (no K1) per
   value-and-grad and [slice]'s recovery bars (R-hat printed, not held:
   the envelope is a measured negative on FN);
17. profile: [default]'s workload and config cut to PROFILE_NITER
   iterations with ``profile_dir`` set: one torch.profiler trace file
   holding the band kernels' launches from the replayed CUDA graphs, and
   draws bit-equal to the same run without it.

The cut runs of [pt] and [chees] are held to bars set from the JAX
package's readings at the same cuts on the same data
(``python -m tests.test_torch_reference_cuts``; PERF.md).

The launches of each main path ([default], [slice], [pt], [chees],
[envelope], [profile]) are
counted from 0 just before its ``solve_magi`` and read just after: each
kernel's count is its launches per value-and-grad on the route the run's
value-and-grad took (the result's ``vg_route``, checked on every path:
"kernel" one centered_vg launch and no K1; "raw" and "autograd" 2 single,
1 pair, 1 pair_t and no centered_vg) times the run's value-and-grad
evaluations, and each K1 launch ran the tile of its chain count (the row
tile at one chain: [default], [profile], [grid] at C = 1 and the MAP warm
start of [pt]; the chain tile at 32 chains and more). The doubling's kernels' are exactly one D1
and one D2 per doubling and one L2 per batched leaf on every NUTS path ([families], [mesh]
on every rank and [grid]'s eager tree included), 0 on [chees]; the
product kernel's one per batched leaf and two per transition on the paths
under a dense metric ([slice], [envelope], [mesh] on every rank), and two
per value-and-grad where the whitening GEMMs take it ([slice], [chees],
[envelope], [mesh]), none elsewhere; its preparation's two where the
whitened value-and-grad is built, and at least one and at most one per
transition under a dense metric.

Each phase prints one line; a failed check exits non-zero. The line before
the card's name is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``. There is no CPU branch: without a CUDA
device the script exits non-zero.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

N_CHAINS = 128
# 250 warmup + 250 draws per chain: at ~0.7 ms per batched leapfrog step
# (value-and-grad replayed from a CUDA graph) and ~600 batched steps per
# iteration, ~300 s, so that the whole script stays near half its time
# limit with the default-path phases (PERF.md; 800 until they came).
NITER_HMC = 500
# The default path: 100 warmup + 100 draws of one chain (the example runs
# 50,000 iterations; cut for time only).
DEFAULT_NITER = 200
DEFAULT_SEED = 12345  # examples/fn_example.py's seed
DEFAULT_TOL_VALUE, DEFAULT_TOL_GRAD = 1e-5, 1e-4
DEFAULT_ACCEPT = (0.6, 0.95)
DEFAULT_MAX_DIVERGENT_SHARE = 0.1
# diag-gauss: dimension, iterations (half warmup), chain counts and bars
# (C = 1 was dropped for time; the first warmup iterations, at depth 10
# under the unit metric, cost the same at any C)
GAUSS_DIM, GAUSS_NITER, GAUSS_CHAINS = 799, 1000, (4,)
# Trees capped at depth 8 for time: under the first window's unit metric
# the trees ran to depth 10, ~84% of the phase's leaves (the bars hold at
# depth 8 on the CPU with a 2.7x margin)
GAUSS_MAX_DEPTH = 8
GAUSS_VAR_TOL, GAUSS_MASS_RANGE, GAUSS_MASS_SHARE = 0.1, (0.5, 2.0), 0.95
MAIN_BANDSIZE = 40  # the band after escalation on this workload (20 -> 40)
LONG_FILL, LONG_BAND_START = 5, 80  # n = 3169; the band escalates to 160
# (M, b, n) of [families]' grids (perf/workload.FAMILY_CASES: ptrans, hiv,
# hes1log_fixg; build_gp_cov clips the default band of 20 to n - 1)
FAMILY_SHAPES = ((5, 14, 15), (4, 11, 12), (3, 12, 13))
KERNEL_SOURCE = "manifold_constrained_gaussian_process_inference_tpu_torch/csrc/band_matvec.cu"
KERNEL_REPLACES = "manifold_constrained_gaussian_process_inference_tpu/ops/pallas_band.py:52"
# The kernels' C entry points and the ops of perf/band_timing.py they run.
KERNELS = {"band_matvec": "single", "band_matvec_pair": "pair",
           "band_matvec_pair_t": "pair_t"}
# The shapes of perf/band_timing.py each kernel is timed at: the slice's
# (the JSON's top-level times), the n=3169 grid's, one chain at both, the
# shapes of [pt], [chees] and a [mesh] rank's, and [grid]'s local blocks
# at C = 128 and 1, where each times only the ops that run there
TIMED_SHAPES = ("main", "long", "main_c1", "long_c1", "pt", "chees", "mesh", "grid_pair",
                "grid_single", "grid_pair_c1", "grid_single_c1")
OPS_AT = {"grid_pair": ("pair", "pair_t"), "grid_pair_c1": ("pair", "pair_t"),
          "grid_single": ("single",), "grid_single_c1": ("single",)}
# The whitened FN value-and-grad's kernel (csrc/centered_vg.cu): the JAX
# package's fused body it takes the place of (log_posterior_centered under
# value_and_grad, as make_centered_whitened_vg builds it)
VG_SOURCE = "manifold_constrained_gaussian_process_inference_tpu_torch/csrc/centered_vg.cu"
VG_REPLACES = ("manifold_constrained_gaussian_process_inference_tpu/ops/likelihood.py:386 and "
               "manifold_constrained_gaussian_process_inference_tpu/inference/whiten.py:527")
VG_KERNEL, VG_PREPARE_KERNEL = "centered_vg", "centered_vg_prepare"
LIKELIHOOD_KERNELS = (*KERNELS, VG_KERNEL)
# A banded value-and-grad's launches by its route (the route attribute of
# make_centered_whitened_vg's function; "raw" the unwhitened target's):
# the kernel route one launch of the whitened FN kernel and no K1; the
# others K1's pair (mphi, GC^T) and single GK^T forward, their two
# launches backward
K1_PER_VG = {"band_matvec": 2, "band_matvec_pair": 1, "band_matvec_pair_t": 1, VG_KERNEL: 0}
LAUNCHES_PER_VG = {"kernel": {**dict.fromkeys(KERNELS, 0), VG_KERNEL: 1},
                   "autograd": K1_PER_VG, "raw": K1_PER_VG}
# [vg]: the kernel against its plain version and its earlier designs at the
# shapes of the paths it runs on (perf/vg_timing.CASES), config 4's grid
# and [likelihood-3169]'s last
VG_CASES = ("slice", "c1", "chees", "mesh", "resume", "n793", "long")
# Tolerances: float64 agrees to rounding; float32 sums run in another order.
TOL_F64, TOL_F32 = 1e-12, 1e-5
TOL_VALUE, TOL_GRAD = 1e-4, 1e-3
THETA_RMSE_MAX, SIGMA_RMSE_MAX, RHAT_MAX = 0.2, 0.05, 1.05
# pt: config 3 cut to PT_NITER iterations (the bench runs 8000; 600 took
# 569 s on the card, PERF.md; 150 until the mesh phases came), its theta bar
# and the sampler-health bars. Config 3's unobserved-H bar (RMSE < 1.0) is a
# bench-length bar; at this cut H is held to the JAX package's worst reading
# at the same cut on the same data over sampler seeds 0, 1, 2 (1.0077-1.0662,
# float64 on the CPU; tests/test_torch_reference_cuts.py, PERF.md), rounded
# up.
PT_NITER, PT_SEED, PT_BANDSIZE = 100, 0, 20
PT_H_RMSE_MAX, PT_SWAP_RANGE = 1.07, (0.1, 0.9)
PT_ACCEPT_RANGE, PT_MAX_DIVERGENT_SHARE = (0.6, 0.99), 0.1
PT_GRAPH_TOL = 1e-6  # float32: the replayed and eager values agree to rounding
# chees: config 7 cut to CHEES_NITER iterations (the bench runs 3000, where
# its R-hat bar is <= 1.05). At the cut, max R-hat is held to the JAX
# package's worst reading over sampler seeds 42 (the smoke's), 1, 2
# (1.1156-2.5222: T is still adapting), rounded up, as [pt]'s H.
CHEES_NITER, CHEES_CHAINS = 600, 64
CHEES_RHAT_MAX = 2.53
CHEES_ACCEPT_RANGE, CHEES_MAX_DIVERGENT_SHARE = (0.6, 0.99), 0.1
# resume: iterations (half warmup) and chunk of each short run; under the
# mesh ([resume-mesh]) half as many, for time
RESUME_NITER, RESUME_CHUNK = 80, 20
RESUME_MESH_NITER, RESUME_MESH_CHUNK = 40, 10
# mesh: ranks (gloo, all on the one card) and [slice]'s recipe cut to
# MESH_NITER iterations (half warmup; at 60, with 3 dual-averaging steps
# after the one metric window, 12.7% of the draws diverged): recovery bars
# as [slice]'s, at most 10% divergent; the JAX package's dry-run bound on
# every sharded-vs-unsharded delta and on the grid-sharded value-and-grad
# against the unsharded one
MESH_RANKS, MESH_NITER, MESH_MAX_DIVERGENT_SHARE = 4, 100, 0.1
DRYRUN_TOL, GRID_TOL = 1e-4, 1e-4
DRYRUN_CALLS = ("chains", "pt", "chees")
GRID_CHAINS = (1, 128)
# the one-rank world of [mesh] (c), and where the ranks' tensors live
MESH_SOLO_BACKEND, DEVICE = "nccl", "cuda"
GRID_NUTS = dict(n_samples=6, n_adapts=3, initial_step_size=1e-4, max_depth=4)
# envelope: ENVELOPE_ADAPTS warmup iterations give two window ends (at 100
# and 150; inference/adapt.py's schedule: init buffer 75, first window 25,
# term buffer 50), so a probe collected after the first is folded at the
# second; warmup chunks of ENVELOPE_CHUNK (at most one probe per chunk);
# the sampling draws cut to 25 for time (the phase's first cut)
ENVELOPE_NITER, ENVELOPE_ADAPTS, ENVELOPE_CHUNK = 225, 200, 25
ENVELOPE_MAX_BOOST_DIMS = 16  # per probe: CurvatureEnvelope's max_boost_dims
# profile: [default] cut to PROFILE_NITER iterations (a trace of the full
# run would hold millions of events)
PROFILE_NITER = 20
# The WHILE node (csrc/graph_if.cu) that keeps the JAX leaf loop on the
# device: checked and timed at GRAPH_WHILE_ITERS iterations (a depth-9
# doubling's pairs after the first, 255), then at the limits of
# GRAPH_WHILE_LIMITS set in place; timed over GRAPH_WHILE_REPS replays
GRAPH_WHILE_ITERS, GRAPH_WHILE_REPS = 255, 20
WHILE_SOURCE = "manifold_constrained_gaussian_process_inference_tpu_torch/csrc/graph_if.cu"
WHILE_REPLACES = "manifold_constrained_gaussian_process_inference_tpu/inference/nuts_batched.py:222"
GRAPH_WHILE_LIMITS = (GRAPH_WHILE_ITERS + 1, 1, 2, 77)
HBM_BYTES_PER_MS = 3.35e9  # the H100's 3.35 TB/s
# The NUTS leaf's kernel (csrc/nuts_leaf.cu, L2): the JAX package's
# fused leaf body they take the place of; checked over one depth-LEAF_DEPTH
# sub-tree at (chains, dim, metric) of [slice], [default], a shared
# diagonal and [pt] (LEAF_RUNGS rungs), with LEAF_ROWS checkpoint rows (a
# depth-10 tree's); a chain's bits at LEAF_SUBSETS' chains of [slice]'s
# launch; timed over LEAF_REPS launches
LEAF_SOURCE = "manifold_constrained_gaussian_process_inference_tpu_torch/csrc/nuts_leaf.cu"
LEAF_REPLACES = "manifold_constrained_gaussian_process_inference_tpu/inference/nuts_batched.py:225"
# the doubling's kernels of csrc/nuts_leaf.cu: D1 the opening, L2 the leaf's
# commit, D2 the merge; the JAX package's bodies D1 and D2 replace (the
# sub-tree's init and the outer loop's merge; L2: LEAF_REPLACES)
LEAF_KERNELS = {"nuts_doubling_open": "open", "nuts_leaf_commit": "commit",
                "nuts_doubling_merge": "merge"}
DOUBLING_REPLACES = {
    "open": "manifold_constrained_gaussian_process_inference_tpu/inference/nuts_batched.py:304",
    "merge": "manifold_constrained_gaussian_process_inference_tpu/inference/nuts_batched.py:423"}
# L1 (nuts_leaf_drift), the drift at a doubling's leaf 0 from PR 9 to PR 14,
# which D1's opening replaced (its times: PERF.md)
L1_REPLACED = dict(name="nuts_leaf_drift", by="nuts_doubling_open", prs="PR 9-14")
# [doubling]: D1 and D2 against their plain versions at LEAF_SHAPES over
# DOUBLING_DEPTHS, track on and off, with every DOUBLING_DONE-th chain done
# before the doubling, and for D2 a sub-tree state in which every
# DOUBLING_DIV-th chain diverged and every DOUBLING_TURN-th turned
DOUBLING_DEPTHS = (0, 3)
DOUBLING_DONE, DOUBLING_DIV, DOUBLING_TURN = 5, 9, 11
LEAF_SHAPES = {"slice": (128, 799, "dense"), "default": (1, 799, "diag"),
               "shared": (32, 799, "shared"), "pt": (40, 105, "rung")}
# checked, not timed: L2's other ways of keeping a chain's rows, in shared
# memory ([grid]'s dim) and in place (three rows over a block's shared memory)
LEAF_STASH_SHAPES = {"grid": (1, 6345, "diag"), "wide": (2, 20000, "shared")}
LEAF_SEEDS = {name: k for k, name in enumerate(sorted(LEAF_SHAPES) + list(LEAF_STASH_SHAPES))}
LEAF_RUNGS, LEAF_DEPTH, LEAF_ROWS, LEAF_REPS = 10, 4, 9, 200
LEAF_SUBSETS = {1: (5,), 3: (7, 8, 9), 32: tuple(range(32, 64))}
# L2 before it wrote the next leaf's q (one pass, no drift), ms per launch at
# LEAF_SHAPES on the H100 (the upper ends of PERF.md's readings), printed
# beside this run's; the target at [slice] is the upper end predicted for L2
# with the drift (PERF.md)
LEAF_PREVIOUS_COMMIT_MS = {"slice": 0.00567, "default": 0.00449, "shared": 0.00498,
                           "pt": 0.00378}
LEAF_COMMIT_TARGET_MS = 0.0063
# The dense metric's product M^-1 g (csrc/minv_mv.cu), which replaces the
# matmul of the JAX package's _minv_mv_b: checked at (chains, dim) of
# [slice], a [mesh] rank, [resume]'s dense NUTS (3 chains, dim 87), one
# chain and config 4 (n = 793, dim 1591), float64 and float32 against the
# float64 plain version; a chain's bits at LEAF_SUBSETS' chain counts of
# [slice]'s launch; timed at PRODUCT_TIMED over LEAF_REPS launches beside
# the plain version (torch.matmul: the library call too), at 67 TFLOP/s
PRODUCT_KERNEL, PREPARE_KERNEL = "minv_mv", "minv_mv_prepare"
PRODUCT_SOURCE = "manifold_constrained_gaussian_process_inference_tpu_torch/csrc/minv_mv.cu"
# The product's first design (its C interface takes minv itself), built
# and timed beside the kernel at PRODUCT_TIMED
PRODUCT_BASELINE = ("manifold_constrained_gaussian_process_inference_tpu_torch/perf/baselines/"
                    "minv_mv_pr13.cu")
# [slice]'s whitened dim: the x block (397 x 2), theta (3) and log sigma (2)
SLICE_DIM = 799
PRODUCT_REPLACES = "manifold_constrained_gaussian_process_inference_tpu/inference/nuts_batched.py:63"
PRODUCT_SHAPES = {"slice": (128, 799), "mesh": (32, 799), "resume": (3, 87), "c1": (1, 799),
                  "n793": (128, 1591)}
PRODUCT_TIMED = ("slice", "mesh", "c1", "n793")
PRODUCT_TOL_F64 = 1e-14  # of the largest |output|
# [vg]: the float32 value-and-grad with its whitening GEMMs on the product
# kernel no further from the float64 one than this times with them on
# torch.matmul (the kernel's GEMMs sum in float64: nearer, or as near)
F32_VG_GEMM_FACTOR = 2.0
FP32_FLOP_PER_MS = 67e9
# tree: the cut of each path run graphed and eager ([envelope] with
# TREE_ENVELOPE_ADAPTS warmup: one window end, then tracked chunks; [pt]'s
# MAP warm start cut to TREE_PT_MAP_ITERS Adam steps)
TREE_NITER = {"slice": 60, "default": 20, "pt": 20, "envelope": 50}
TREE_ENVELOPE_ADAPTS, TREE_PT_MAP_ITERS = 40, 300
TREE_DEPTHS = 10  # of the tree whose every depth [tree] captures up front
# counts that differ between the graphed and the eager tree by design
TREE_HOST_COUNTS = ("host_syncs", "tree_reads", "graph_capture_s")
# the value-and-grad route of each [tree] path (and of its own phase)
TREE_ROUTES = {"slice": "kernel", "default": "raw", "pt": "autograd", "envelope": "kernel"}


def pt_config(seed: int = PT_SEED) -> dict:
    """Config 3 at the smoke's cut: the MagiConfig arguments that both
    packages take (the reference run uses them too)."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.perf.workload import (
        HES1_CONFIG3,
    )

    return {**HES1_CONFIG3, "niter_hmc": PT_NITER, "seed": seed}


def slice_config(niter: int) -> dict:
    """[slice]'s production recipe at ``niter`` iterations: MagiConfig
    arguments."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.perf.workload import SEED

    return dict(
        niter_hmc=niter, burnin_ratio=0.5, step_size_factor=0.06,
        prior_temperature=(1.0, 1.0, 1.0), sampler="nuts", n_chains=N_CHAINS,
        mass_matrix="dense-pooled", chain_init_jitter=0.05, x_whitened=True,
        theta_constrained=True, target_accept_ratio=0.95, step_jitter=0.125,
        seed=SEED, chunk_size=250, band_impl="band", device=DEVICE,
    )


def chees_config(y, t, seed: int) -> dict:
    """Config 7 at the smoke's cut, phi from the NLML on the observations
    (every 4th grid point), as the bench does; arguments of both packages'
    MagiConfig."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.inference.nlml import (
        optimize_gp_hyperparameters,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.perf.workload import (
        SIGMA_TRUE,
    )

    hp = optimize_gp_hyperparameters(y[::4], t[::4], "matern52")
    return dict(
        niter_hmc=CHEES_NITER, step_size_factor=0.06, seed=seed, target_accept_ratio=0.95,
        prior_temperature=(1.0, 1.0, 1.0), phi=hp[:, :2].T, sigma=np.full(2, SIGMA_TRUE),
        sampler="chees", chees_criterion="snaper", n_chains=CHEES_CHAINS, x_whitened=True,
        theta_constrained=True, chain_init_jitter=0.05, mass_matrix="dense-pooled",
        chunk_size=250,
    )


def max_rhat(theta_per_chain) -> float:
    from manifold_constrained_gaussian_process_inference_tpu_torch.postprocess.diagnostics import (
        split_rhat,
    )

    return max(split_rhat(theta_per_chain[:, :, j]) for j in range(theta_per_chain.shape[-1]))


def rmse(a, b) -> float:
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def digest(*arrays) -> str:
    """A hash of arrays' bytes: ranks hold equal results iff they agree."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def wall_ms(fn, n_runs: int = 20) -> float:
    """Host ms per call of fn(), synchronized at both ends (for calls that
    end in a collective, which waits on the host), after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_runs):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n_runs


def cuda_ms(fn, n_runs: int = 50) -> float:
    """Median of ``n_runs`` CUDA-event timings of fn(), after a warm-up."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(n_runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on")
    check(not torch.backends.cudnn.allow_tf32, "TF32 cuDNN is on")
    check(torch.get_float32_matmul_precision() == "highest", "float32 matmul precision")
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}; TF32 off", flush=True)
    return smi


def phase_build(cb):
    """nvcc of every CUDA source of the port, one process each, together."""
    from concurrent.futures import ThreadPoolExecutor

    from manifold_constrained_gaussian_process_inference_tpu_torch.ops import (
        centered_vg, graph_if, leaf, minv_mv,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.perf import vg_timing

    t0 = time.perf_counter()
    # the kernels, the earlier centered_vg kernels that [vg] holds the new one
    # to and the product's first design that [leaf] times beside the kernel
    sources = (cb.SOURCE, graph_if.SOURCE, leaf.SOURCE, minv_mv.SOURCE, centered_vg.SOURCE,
               vg_timing.BASELINE, vg_timing.BASELINE_PR12,
               Path(__file__).resolve().parent / PRODUCT_BASELINE)
    with ThreadPoolExecutor(len(sources)) as pool:
        sos = list(pool.map(cb.build, sources))
    check(set(LEAF_KERNELS) == set(leaf.LAUNCHES), f"leaf kernels {sorted(leaf.LAUNCHES)}")
    print(f"[build] {[so.name for so in sos]} in {time.perf_counter() - t0:.2f} s", flush=True)


def _vg_rates(vg, x):
    """Chain-evaluations per second of vg(x), eager and replayed from a CUDA
    graph (CUDA events, median of 20), and the graph's launches."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.parallel.chains import (
        GraphedValueAndGrad,
    )

    graphed = GraphedValueAndGrad(vg, x)
    rates = tuple(x.shape[0] * 1e3 / cuda_ms(lambda: f(x), 20) for f in (vg, graphed))
    return rates, graphed.kernel_launches


def phase_likelihood(y, t):
    """Whitened, mode-centered value-and-grad on the card, band vs dense in
    float32, both against float64 on the CPU, at one batch of C zetas."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.perf.workload import (
        slice_likelihood,
    )

    lik = slice_likelihood(y, t, bandsize=MAIN_BANDSIZE)
    zeta = np.random.default_rng(1).normal(size=(N_CHAINS, lik.dimension)) * 0.5
    v64, g64 = (a.numpy() for a in lik.vg("dense", torch.float64, "cpu")(torch.as_tensor(zeta)))
    zeta32 = torch.as_tensor(zeta, dtype=torch.float32, device="cuda")
    out, rates, vals, launches, routes = {}, {}, {}, {}, {}
    for impl in ("band", "dense"):
        vg = lik.vg(impl)
        routes[impl] = vg.route
        vals[impl] = vg(zeta32)
        torch.cuda.synchronize()
        v, g = (a.double().cpu().numpy() for a in vals[impl])
        check(np.isfinite(v).all() and np.isfinite(g).all(), f"{impl}: non-finite")
        out[impl] = (float(np.max(np.abs(v - v64) / np.abs(v64))),
                     float(np.max(np.abs(g - g64)) / np.max(np.abs(g64))))
        rates[impl], launches[impl] = _vg_rates(vg, zeta32)
    (vb, gb), (vd, gd) = vals["band"], vals["dense"]
    band_vs_dense = (float(((vb - vd).abs() / vd.abs()).max()),
                     float((gb - gd).abs().max() / gd.abs().max()))
    for impl, (ev, eg) in out.items():
        check(ev <= TOL_VALUE, f"{impl} value rel err {ev:.3e} > {TOL_VALUE}")
        check(eg <= TOL_GRAD, f"{impl} grad err {eg:.3e} > {TOL_GRAD} of max |grad|")
    check(band_vs_dense[0] <= TOL_VALUE and band_vs_dense[1] <= TOL_GRAD, "band vs dense")
    per_vg = launches["band"]
    want = {name: LAUNCHES_PER_VG["kernel"][name] for name in LIKELIHOOD_KERNELS}
    check(routes == {"band": "kernel", "dense": "autograd"}, f"likelihood: routes {routes}")
    check(per_vg == want, f"kernel launches in the value-and-grad's graph {per_vg}, want {want}")
    print(f"[likelihood] C={N_CHAINS} dim={lik.dimension} bandsize={lik.cov64.bandsize} float32 "
          f"vs float64 CPU: band value rel {out['band'][0]:.3e} grad {out['band'][1]:.3e}; dense "
          f"value rel {out['dense'][0]:.3e} grad {out['dense'][1]:.3e}; band vs dense value "
          f"{band_vs_dense[0]:.3e} grad {band_vs_dense[1]:.3e}; value-and-grad evals/s "
          f"(chains x calls) eager / CUDA-graph replay: band {rates['band'][0]:.0f} / "
          f"{rates['band'][1]:.0f}, dense {rates['dense'][0]:.0f} / {rates['dense'][1]:.0f}; "
          f"routes {routes}; kernel launches in the band value-and-grad's graph {per_vg}",
          flush=True)


def phase_likelihood_3169():
    """Mode-centered value-and-grad of C chains at the true theta and
    sigma on the filllevel-5 grid (n=3169), band against dense in float32
    on the card, eager and replayed; chain 0 against float64 on the CPU."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.inference.solve import (
        _init_x_interpolation,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.inference.target import (
        MagiTarget, value_and_grad,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.models import FN_SYSTEM
    from manifold_constrained_gaussian_process_inference_tpu_torch.ops.gp_cov import build_gp_cov
    from manifold_constrained_gaussian_process_inference_tpu_torch.ops.likelihood import (
        log_posterior_centered, make_centered_terms,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.perf.workload import (
        PHI, SIGMA_TRUE, TEMPS, THETA_TRUE, fn_bench_workload,
    )

    y, t = fn_bench_workload(fill=LONG_FILL)
    t0 = time.perf_counter()
    cov64 = build_gp_cov("matern52", PHI, t, bandsize=LONG_BAND_START)
    cov_s = time.perf_counter() - t0
    n, b = len(t), cov64.bandsize
    x_ref = _init_x_interpolation(y, t)
    dx = np.random.default_rng(2).normal(size=(N_CHAINS, n, 2)) * 0.05
    sigma = np.full(2, SIGMA_TRUE)

    def make_vg(impl, dtype, device, chains):
        cov = cov64.to(dtype=dtype, device=device)
        target = MagiTarget.build(y, cov, FN_SYSTEM, sigma, TEMPS, True, band_impl=impl)
        cent = make_centered_terms(target.data, x_ref, b)
        put = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        theta = put(np.tile(THETA_TRUE, (chains, 1)))
        return value_and_grad(lambda d: log_posterior_centered(
            d, theta, target.sigma_init, target.data, cent, FN_SYSTEM.f, b)), put

    vg64, put64 = make_vg("band", torch.float64, "cpu", 1)
    v64, g64 = (a.numpy() for a in vg64(put64(dx[:1])))
    vals, rates, err = {}, {}, {}
    for impl in ("band", "dense"):
        vg, put = make_vg(impl, torch.float32, "cuda", N_CHAINS)
        x = put(dx)
        vals[impl] = vg(x)
        torch.cuda.synchronize()
        v, g = (a.double().cpu().numpy() for a in vals[impl])
        check(np.isfinite(v).all() and np.isfinite(g).all(), f"n=3169 {impl}: non-finite")
        err[impl] = (float(abs(v[0] - v64[0]) / abs(v64[0])),
                     float(np.max(np.abs(g[0] - g64[0])) / np.max(np.abs(g64[0]))))
        rates[impl], _ = _vg_rates(vg, x)
        del vg, x
        torch.cuda.empty_cache()
    (vb, gb), (vd, gd) = vals["band"], vals["dense"]
    band_vs_dense = (float(((vb - vd).abs() / vd.abs()).max()),
                     float((gb - gd).abs().max() / gd.abs().max()))
    for impl, (ev, eg) in err.items():
        check(ev <= TOL_VALUE and eg <= TOL_GRAD,
              f"n=3169 {impl} vs float64: value rel {ev:.3e}, grad {eg:.3e}")
    check(band_vs_dense[0] <= TOL_VALUE and band_vs_dense[1] <= TOL_GRAD,
          f"n=3169 band vs dense {band_vs_dense}")
    print(f"[likelihood-3169] n={n} C={N_CHAINS} bandsize {LONG_BAND_START} -> {b} "
          f"(covariances {cov_s:.1f} s, host float64); chain 0 float32 vs float64 CPU: band value "
          f"rel {err['band'][0]:.3e} grad {err['band'][1]:.3e}, dense value rel "
          f"{err['dense'][0]:.3e} grad {err['dense'][1]:.3e}; band vs dense value "
          f"{band_vs_dense[0]:.3e} grad {band_vs_dense[1]:.3e}; value-and-grad evals/s (chains x "
          f"calls) eager / CUDA-graph replay: band {rates['band'][0]:.0f} / {rates['band'][1]:.0f}, "
          f"dense {rates['dense'][0]:.0f} / {rates['dense'][1]:.0f}", flush=True)
    return _grid_inputs(y, t, cov64, x_ref)


def _grid_inputs(y, t, cov64, x_ref):
    """[grid]'s inputs, made where the n=3169 covariances are: every rank's
    blocks (host float64), raw states psi (C, dim) near the interpolated x
    at the true theta and sigma, and the unsharded banded value-and-grad at
    them: on the card in float32 (with its ms per call, replayed from a CUDA
    graph) and float64 at each C of GRID_CHAINS, and chain 0 in float64 on
    the CPU."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.inference.target import (
        MagiTarget,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.models import FN_SYSTEM
    from manifold_constrained_gaussian_process_inference_tpu_torch.parallel.chains import (
        GraphedValueAndGrad,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.parallel.grid import (
        make_grid_sharded_data,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.perf.workload import (
        SIGMA_TRUE, TEMPS, THETA_TRUE,
    )

    c, n = max(GRID_CHAINS), len(t)
    sigma = np.full(2, SIGMA_TRUE)
    x = x_ref[None] + 0.001 * np.random.default_rng(3).normal(size=(c, n, 2))
    psi = np.concatenate([x.transpose(0, 2, 1).reshape(c, -1), np.tile(THETA_TRUE, (c, 1)),
                          np.tile(np.log(sigma), (c, 1))], axis=1)
    out = dict(psi=psi, sigma=sigma, ref={}, ms={}, cov64=cov64,
               data=make_grid_sharded_data(y, cov64, TEMPS, MESH_RANKS, dtype=torch.float32))
    vg = lambda dtype, device: MagiTarget.build(  # noqa: E731
        y, cov64, FN_SYSTEM, sigma, TEMPS, False, dtype=dtype, device=device,
        band_impl="band").value_and_grad_fn()
    for dtype in (torch.float32, torch.float64):
        vg_card = vg(dtype, DEVICE)
        for chains in GRID_CHAINS:
            x = torch.as_tensor(psi[:chains], dtype=dtype, device=DEVICE)
            out["ref"][chains, dtype] = tuple(a.double().cpu().numpy() for a in vg_card(x))
            if dtype == torch.float32:
                graphed = GraphedValueAndGrad(vg_card, x)
                out["ms"][chains] = cuda_ms(lambda: graphed(x), 20)
    out["ref64_cpu"] = tuple(a.numpy() for a in vg(torch.float64, "cpu")(torch.as_tensor(psi[:1])))
    return out


def _autograd_errors(cb, plain, c, m, b, n, dtype, rng):
    """The single and paired ops through autograd against their plain
    versions at one shape: kernel name -> (max abs err, rel err)."""
    put = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=dtype, device="cuda")
    bs, bst, bs2, bst2 = (put(m, 2 * b + 1, n) for _ in range(4))
    x = put(c, m, n).requires_grad_(True)
    g, g2 = put(c, m, n), put(c, m, n)
    y = cb.band_matvec(bs, bst, x, b)
    (gx,) = torch.autograd.grad(y, x, g)
    ya, yb = cb.band_matvec_pair(bs, bst, bs2, bst2, x, b)
    (gx2,) = torch.autograd.grad((ya, yb), x, (g, g2))
    torch.cuda.synchronize()
    x = x.detach()
    pairs = {
        "band_matvec": [(y, plain["single"](bs, x, b)), (gx, plain["single"](bst, g, b))],
        "band_matvec_pair": list(zip((ya, yb), plain["pair"](bs, bs2, x, b))),
        "band_matvec_pair_t": [(gx2, plain["pair_t"](bst, bst2, g, g2, b))],
    }
    return {
        name: (max(float((u.detach() - w).abs().max()) for u, w in got),
               max(float((u.detach() - w).abs().max() / w.abs().max()) for u, w in got))
        for name, got in pairs.items()
    }


def _tile_equality(cb, shapes, chains, rng):
    """Each chain's outputs of the three entry points at few chains against
    its rows of one launch at 128 chains (the few are rows of that batch),
    in float32 and float64: exactly equal. Returns the number of chains
    compared."""
    compared = 0
    for m, b, n in shapes:
        for dtype in (torch.float32, torch.float64):
            put = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=dtype, device="cuda")
            ba, bb = put(m, 2 * b + 1, n), put(m, 2 * b + 1, n)
            xa, xb = put(128, m, n), put(128, m, n)
            ops = {
                "single": lambda u, v: (cb.band_matvec_cuda(ba, u, b),),
                "pair": lambda u, v: cb.band_matvec_pair_cuda(ba, bb, u, b),
                "pair_t": lambda u, v: (cb.band_matvec_pair_t_cuda(ba, bb, u, v, b),),
            }
            full = {op: f(xa, xb) for op, f in ops.items()}
            for c in chains:
                idx = torch.as_tensor(np.sort(rng.choice(128, size=c, replace=False)),
                                      device="cuda")
                for op, f in ops.items():
                    got = f(xa[idx].contiguous(), xb[idx].contiguous())
                    same = all(torch.equal(u, w[idx]) for u, w in zip(got, full[op]))
                    check(same, f"kernel {op} at C={c}, (M, b, n)={(m, b, n)}, {dtype}: a "
                                f"chain's outputs differ from its rows of a 128-chain launch")
                compared += c
    torch.cuda.synchronize()
    return compared


def phase_kernel(cb):
    from manifold_constrained_gaussian_process_inference_tpu_torch.ops.band import (
        band_matvec_pair_t_torch, band_matvec_pair_torch, band_storage_matvec_torch,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.perf import band_timing as bt

    plain = {"single": band_storage_matvec_torch, "pair": band_matvec_pair_torch,
             "pair_t": band_matvec_pair_t_torch}
    rng = np.random.default_rng(0)
    cb.reset_launches()
    main, long = bt.SHAPES["main"], bt.SHAPES["long"]
    # the default path's shapes: one chain (and five) at both grids, two and
    # three at [grid]'s GK^T block; [pt]'s, [chees]'s, a [mesh] rank's and
    # [grid]'s blocks
    few = [(c, *shape[1:]) for shape in (main, long) for c in (1, 5)]
    few += [(c, *bt.SHAPES["grid_single"][1:]) for c in (2, 3)]
    few += [bt.SHAPES[k] for k in ("pt", "chees", "mesh", "grid_pair", "grid_single",
                                   "grid_pair_c1", "grid_single_c1")]
    # one chain at [pt]'s shape (its MAP warm start) and at [families]'
    few += [(1, *bt.SHAPES["pt"][1:])] + [(1, *s) for s in FAMILY_SHAPES]
    # n < 2b+1, b = 0, n not a multiple of a tile, b at the TPU kernel's
    # limit, b > 64 with n < 2b+1, and C not a multiple of the chain tile
    edges = [(3, 2, 5, 7), (2, 3, 0, 130), (4, 2, 3, 129), (1, 2, 64, 200), (5, 2, 40, 50),
             (3, 2, 70, 150), (33, 2, 100, 170)]
    # the row tile's chain counts and the threshold's neighbours, each
    # chain against a 128-chain launch (the chain tile) at both grids,
    # [grid]'s GK^T block and every edge's (M, b, n)
    equal_chains = sorted({1, 2, 3, cb.ROW_TILE_BELOW - 1, cb.ROW_TILE_BELOW})
    equal_shapes = [(2, 40, 397), (2, 160, 1113), (2, 160, 3169), bt.SHAPES["pt"][1:],
                    *FAMILY_SHAPES] + [e[1:] for e in edges]
    n_equal = _tile_equality(cb, equal_shapes, equal_chains, rng)
    worst, main_err = {}, {}
    for shape in [main, long] + few + edges:
        for dtype in (torch.float64, torch.float32):
            errs = _autograd_errors(cb, plain, *shape, dtype, rng)
            tol = TOL_F64 if dtype == torch.float64 else TOL_F32
            for name, (abs_err, rel) in errs.items():
                check(rel <= tol, f"{name} vs plain at {shape} {dtype}: rel {rel:.3e} > {tol}")
                worst[dtype] = max(worst.get(dtype, 0.0), rel)
                if shape == main and dtype == torch.float32:
                    main_err[name] = abs_err
    # the (M, n) form of the parity API
    x2 = torch.as_tensor(rng.normal(size=(2, 397)), dtype=torch.float64, device="cuda")
    bs2 = torch.as_tensor(rng.normal(size=(2, 2 * MAIN_BANDSIZE + 1, 397)), device="cuda")
    want = band_storage_matvec_torch(bs2, x2, MAIN_BANDSIZE)
    rel2 = float((cb.band_matvec_cuda(bs2, x2, MAIN_BANDSIZE) - want).abs().max() / want.abs().max())
    check(rel2 <= TOL_F64, f"kernel (M, n) form: rel {rel2:.3e}")
    checked_tiles = dict(cb.TILE_LAUNCHES)
    timing = {}
    for label in TIMED_SHAPES:
        shape = bt.SHAPES[label]
        for op, case in bt.op_cases(shape, torch.float32, rng).items():
            if op not in OPS_AT.get(label, KERNELS.values()):
                continue
            fns = {"kernel": case["wrapper"], "plain": case["plain"], "library": case["library"]}
            times = {tag: [] for tag in fns}
            for tag in ("kernel", "plain", "library", "kernel"):  # in turns
                times[tag].append(bt.graph_ms(fns[tag]))
            timing[(label, op)] = dict(
                ms=float(np.mean(times["kernel"])), plain_ms=times["plain"][0],
                library_ms=times["library"][0], bound_ms=case["bound"][0],
                bound_by=case["bound"][1], tile=cb.tile_for(shape[0], shape[2], torch.float32),
            )
    cells = "; ".join(
        f"{label} {op} ({v['tile']}): kernel {v['ms']:.5f} plain {v['plain_ms']:.5f} matmul "
        f"{v['library_ms']:.5f} bound {v['bound_ms']:.5f} ({v['bound_by']})"
        for (label, op), v in timing.items()
    )
    # one chain: the row tile against the GEMV and its plain version
    one_chain = {f"{label} {op}": v["ms"] <= min(v["library_ms"], v["plain_ms"])
                 for (label, op), v in timing.items() if bt.SHAPES[label][0] == 1}
    print(f"[kernel] single, pair and pair_t against their plain versions, forward and backward, "
          f"at {2 + len(few) + len(edges)} shapes (C in 1, 5, 128 at both grids, 2 and 3 at "
          f"{bt.SHAPES['grid_single'][1:]}, [pt]'s "
          f"{bt.SHAPES['pt']} and at C = 1, [families]' {FAMILY_SHAPES} at C = 1, [chees]'s "
          f"{bt.SHAPES['chees']}, a [mesh] rank's "
          f"{bt.SHAPES['mesh']}, [grid]'s blocks {bt.SHAPES['grid_pair']} and "
          f"{bt.SHAPES['grid_single']} at C = 128 and 1): worst rel float64 "
          f"{worst[torch.float64]:.3e} (tol {TOL_F64}), float32 {worst[torch.float32]:.3e} (tol "
          f"{TOL_F32}); max abs err at the main shape float32 {main_err}; each chain at C in "
          f"{equal_chains} (row tile below {cb.ROW_TILE_BELOW}) bit-equal to its rows of a "
          f"128-chain launch, float32 and float64, all three entry points, at (M, b, n) "
          f"{equal_shapes}: {n_equal} chains; launches by tile in these checks {checked_tiles}; "
          f"ms per launch (CUDA graph of {bt.COUNT}, CUDA events) at (C, M, b, n) "
          f"{[bt.SHAPES[k] for k in TIMED_SHAPES]}: {cells}; at one chain no slower than the "
          f"GEMV and the plain version: {one_chain}", flush=True)
    return main_err, timing


def phase_vg(long_cov64):
    """The whitened FN value-and-grad's kernel (csrc/centered_vg.cu)
    against its plain version at VG_CASES' shapes (``perf/vg_timing``:
    float64 within 1e-12 relative of the plain version and of the scalar
    cluster kernel, float32 within twice the plain version's and that
    kernel's own error against float64, a chain's bits the same at C = 1,
    3 and 32 as in the whole launch; the prepared tiles of its preparation
    bit-equal to ``prepare_tiles_torch``; a launch of at most TARGET_BLOCKS
    blocks within the clusters the card runs at once), timed per launch (a replayed graph of
    200) in both dtypes beside the scalar cluster kernel and the one-block
    kernel, its bound and its plain version, with the tiling it ran and the tile bytes it read, and
    the whole value-and-grad per replayed call on both routes (float32).
    ``long_cov64``: [likelihood-3169]'s covariances."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.perf import vg_timing as vt

    rows, parts = {}, []
    for name in VG_CASES:
        case = vt.make_case(name, long_cov64 if name.startswith("long") else None)
        try:
            err = vt.check_case(case)
        except AssertionError as e:
            raise SmokeFailure(f"vg: {e}") from e
        t32 = vt.time_case(case, torch.float32)
        t64 = vt.time_case(case, torch.float64, whole=False)
        rows[name] = dict(check=err, float32=t32, float64=t64)
        tile = t32["tiling"]
        parts.append(
            f"{name} (C={case['chains']}, n={case['n']}, b={case['bandwidth']}; S={tile['cluster']} "
            f"L={tile['slab']} Cg={tile['chains']} threads={tile['threads']}; "
            f"{err['clusters']} clusters, {err['active_clusters']} at once on the card; tiles "
            f"{t32['tile_bytes'] / 2**20:.2f} MiB from L2; prepared tiles bit-equal to "
            f"prepare_tiles_torch in both dtypes, preparation ms float32 {t32['prepare_ms']:.5f} "
            f"/ bound {t32['prepare_bound_ms']:.5f} bytes / plain (eager) "
            f"{t32['prepare_plain_ms']:.4f}): float64 rel lp "
            f"{err['lp_float64']:.2e} g {err['g_float64']:.2e} (to the scalar cluster kernel "
            f"{err['lp_rel_pr12_float64']:.1e} / {err['g_rel_pr12_float64']:.1e}); float32 vs "
            f"float64 lp {err['lp_float32']:.2e} (plain {err['lp_float32_plain']:.2e}, scalar "
            f"{err['lp_float32_pr12']:.2e}) g {err['g_float32']:.2e} (plain "
            f"{err['g_float32_plain']:.2e}, scalar {err['g_float32_pr12']:.2e}); bits equal at "
            f"C = 1, 3, 32; ms per launch float32 {t32['ms']:.5f} (scalar {t32['pr12_ms']:.5f}, "
            f"one-block {t32['pr11_ms']:.5f}) / bound {t32['bound_ms']:.5f} {t32['bound_by']} / "
            f"plain {t32['plain_ms']:.4f}, float64 {t64['ms']:.5f} (scalar {t64['pr12_ms']:.5f}, "
            f"one-block {t64['pr11_ms']:.5f}) / bound {t64['bound_ms']:.5f} / plain "
            f"{t64['plain_ms']:.4f}; GEMMs torch.matmul {_rounded(t32['gemm_ms'])}, product "
            f"kernel {_rounded(t32['gemm_kernel_ms'])} (taken: {t32['gemm_route']}); "
            f"value-and-grad per replayed call kernel route {t32['vg_ms']['kernel']:.4f} (its "
            f"GEMMs on torch.matmul {t32['vg_ms']['kernel_matmul_gemms']:.4f}), autograd route "
            f"{t32['vg_ms']['autograd']:.4f}; float32 rel to the float64 autograd route, GEMMs on "
            f"the kernel lp "
            f"{t32['vg_rel']['kernel_gemms']['lp']:.2e} g {t32['vg_rel']['kernel_gemms']['g']:.2e}"
            f", on torch.matmul lp {t32['vg_rel']['matmul_gemms']['lp']:.2e} g "
            f"{t32['vg_rel']['matmul_gemms']['g']:.2e}")
        for what in ("lp", "g"):
            got, ref = (t32["vg_rel"][k][what] for k in ("kernel_gemms", "matmul_gemms"))
            check(got <= F32_VG_GEMM_FACTOR * ref, f"vg {name}: float32 {what} rel {got:.3e} with "
                  f"the GEMMs on the kernel, over {F32_VG_GEMM_FACTOR} x torch.matmul's {ref:.3e}")
    print("[vg] the whitened FN value-and-grad's kernel against its plain version and its earlier "
          "designs on the card: " + "; ".join(parts), flush=True)
    return rows


def _rounded(values, digits=5):
    return [round(v, digits) for v in values]


class _Launches:
    """ops/cuda_band's launch counts with the leaf kernels' (ops/leaf), the
    dense metric's product's (ops/minv_mv) and the whitened FN kernel's
    tile preparation's (ops/centered_vg) beside them; everything else is
    cuda_band's."""

    def __init__(self, cb):
        from manifold_constrained_gaussian_process_inference_tpu_torch.ops import (
            centered_vg, leaf, minv_mv,
        )

        self._cb, self._others = cb, (leaf, minv_mv, centered_vg)

    def __getattr__(self, name):
        return getattr(self._cb, name)

    def reset_launches(self) -> None:
        self._cb.reset_launches()
        for module in self._others:
            module.reset_launches()

    def counts(self) -> dict:
        return {**self._cb.counts(), **{k: v for m in self._others for k, v in m.LAUNCHES.items()}}


def _leaf_launches(launches, leaves, doublings, what, dense_transitions=None,
                   whitened=None, eager=False) -> None:
    """A path's doubling-kernel launches: exactly one D1 and one D2 per
    doubling its trees ran (``doublings``) and one L2 per batched leaf
    (``leaves``); 0 where no NUTS tree runs. The product kernel: under a
    dense metric (a path given ``dense_transitions``, its NUTS transitions
    under a ``DenseMetric``) one launch per batched leaf and two per
    transition (its start's M^-1 p0 and M^-1 grad); on the kernel route's
    whitened value-and-grad (``whitened``: its (chains, dim)) two per
    value-and-grad (one per ``centered_vg`` launch) where the GEMM rule
    (``centered_vg.gemm_takes_kernel``) takes the kernel; none elsewhere.
    Its preparation: two for the whitened value-and-grad (W and W^T), and
    under a dense metric one per transition (the graphed tree's copy,
    rewritten at every transition); an ``eager`` tree reads the caller's
    metric and prepares each new one once: at least one, at most one per
    transition."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.ops import centered_vg

    gemm = whitened is not None and centered_vg.gemm_takes_kernel(*whitened)
    got = {name: launches[name] for name in (*LEAF_KERNELS, PRODUCT_KERNEL)}
    want = {"nuts_doubling_open": doublings, "nuts_leaf_commit": leaves,
            "nuts_doubling_merge": doublings,
            PRODUCT_KERNEL: (0 if dense_transitions is None else leaves + 2 * dense_transitions)
            + (2 * launches[VG_KERNEL] if gemm else 0)}
    check(got == want, f"{what}: doubling-kernel and product launches {got}, want {want} (one "
          f"D1 and one D2 per doubling, one L2 per batched leaf; a dense metric's product one "
          f"per leaf and "
          f"two per transition; the whitening GEMMs' two per value-and-grad: {gemm})")
    preps = 2 if whitened is not None else 0
    high = preps + (dense_transitions or 0)
    low = preps + min(1, high - preps) if eager else high
    check(low <= launches[PREPARE_KERNEL] <= high,
          f"{what}: {launches[PREPARE_KERNEL]} preparations of the product's operand, want "
          f"{low}..{high} (W and W^T once; a dense metric once per transition, an eager tree's "
          f"at most)")


def _host_reads(d, what) -> str:
    """A result's host reads per transition in its NUTS trees against its
    doublings per transition: each transition reads at most its doublings
    + 1 (one read per doubling, and a ``max`` over the ranks of a mesh);
    and the seconds its trees' graph captures took."""
    per, dbl = d["tree_reads"] / d["transitions"], d["doublings"] / d["transitions"]
    check(d["tree_reads"] <= d["doublings"] + d["transitions"],
          f"{what}: {per:.2f} host reads per transition over {dbl:.2f} doublings")
    return (f"host reads/transition {per:.3f} (doublings {dbl:.3f}), graph capture "
            f"{d['graph_capture_s']:.2f} s")


def _host_loop(limit: int) -> int:
    """The WHILE node's plain version: the host's loop of the probe's body
    (counter += 1 while counter < limit, after the first test upstream)."""
    k = 1
    while k < limit:
        k += 1
    return k


def phase_graph_if():
    """A WHILE node against the host loop: one graph holds a probe kernel
    (ops/graph_if.probe: counter += 1, the condition set to counter <
    limit) and a WHILE node whose body is that kernel again; the limit is
    read from the device, so one capture runs each of GRAPH_WHILE_LIMITS
    after it is set in place. Timed per iteration from replays of
    GRAPH_WHILE_ITERS iterations less replays of none."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.ops import graph_if as gi

    dev = torch.device(DEVICE)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    limit = torch.zeros(1, dtype=torch.int32, device=dev)
    loops = gi.WhileNodes(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        counter.zero_()
        handle = loops.handle()
        gi.probe(handle, counter, limit)  # the first test, upstream of the node
        loops.loop(handle, lambda: gi.probe(handle, counter, limit))
    got = {}
    for lim in GRAPH_WHILE_LIMITS:
        limit.fill_(lim)
        graph.replay()
        got[lim] = int(counter.item())
    want = {lim: _host_loop(lim) for lim in GRAPH_WHILE_LIMITS}
    err = max(abs(got[lim] - want[lim]) for lim in GRAPH_WHILE_LIMITS)

    def replays_ms(lim):
        limit.fill_(lim)
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(GRAPH_WHILE_REPS):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / GRAPH_WHILE_REPS

    ms = (replays_ms(GRAPH_WHILE_ITERS + 1) - replays_ms(1)) / GRAPH_WHILE_ITERS
    # the host loop on the card: the counter advanced and the condition read
    # by the host at every iteration, as the eager tree reads alive.any()
    counter.zero_()
    limit.fill_(GRAPH_WHILE_ITERS + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
        counter.add_(1)
        if not bool(counter < limit):
            break
    plain_ms = 1e3 * (time.perf_counter() - t0) / GRAPH_WHILE_ITERS
    timing = dict(ms=ms, plain_ms=plain_ms, bound_ms=12 / HBM_BYTES_PER_MS, bound_by="bytes",
                  library_ms=None, iterations=GRAPH_WHILE_ITERS)
    print(f"[graph-if] one WHILE node ({gi.SOURCE.name}) against the host loop: counters after "
          f"the replays at limits {list(GRAPH_WHILE_LIMITS)}: {list(got.values())} (host loop "
          f"{list(want.values())}), max abs err {err}; {loops.body_nodes} body node; ms per "
          f"iteration (the body's kernel and the condition) {ms:.5f} vs the host loop's "
          f"{plain_ms:.5f}; bound (12 bytes) {timing['bound_ms']:.3e}", flush=True)
    check(err == 0, f"graph-if: the WHILE node ran other iterations than the host loop {got}")
    return err, timing


class _GivenVelocity:
    """A metric whose product is given: the plain commit then times the
    bookkeeping alone, as L2 does after a dense metric's matmul."""

    def __init__(self, mg):
        self.mg = mg

    def velocity(self, g):
        return self.mg


def _leaf_case(name, dtype):
    """[leaf]'s inputs at one of LEAF_SHAPES: a sub-tree's start (every
    chain's q, p, grad consistent with its metric, every 7th chain not
    alive, at two chains the second; the tree's two q buffers, by the
    leaf's parity), its metric, signed steps spread over [0.01, 0.5], the
    uniforms of a depth-LEAF_DEPTH sub-tree and a Gaussian value-and-grad in
    which one chain's leaves diverge and another's turn NaN after a few
    leaves."""
    from types import SimpleNamespace

    from manifold_constrained_gaussian_process_inference_tpu_torch.inference.nuts import (
        DenseMetric, DiagMetric, RungDenseMetric,
    )

    c, dim, kind = {**LEAF_SHAPES, **LEAF_STASH_SHAPES}[name]
    rng = np.random.default_rng(LEAF_SEEDS[name])
    put = lambda a: torch.as_tensor(a, dtype=dtype, device=DEVICE)  # noqa: E731
    if kind in ("dense", "rung"):
        k = LEAF_RUNGS if kind == "rung" else 1
        a = rng.normal(size=(k, dim, dim)) / np.sqrt(dim)
        minv = put(0.3 * a @ a.transpose(0, 2, 1) + np.eye(dim))
        metric = (RungDenseMetric(minv, minv, minv) if kind == "rung"
                  else DenseMetric(minv[0], minv[0], minv[0]))
    else:
        metric = DiagMetric(put(rng.uniform(0.5, 2.0, size=(dim,) if kind == "shared"
                                            else (c, dim))))
    scale = put(rng.uniform(0.5, 2.0, size=dim))
    calls = [0]

    def vg(q):
        lp = -0.5 * (scale * q * q).sum(-1)
        if c > 2 and calls[0] >= 4:
            lp[c - 1] = float("nan")
        if c > 2 and calls[0] >= 6:
            lp[2] -= 5e3
        calls[0] += 1
        return lp, -scale * q

    q, p = put(rng.normal(size=(c, dim))), put(rng.normal(size=(c, dim)))
    g = -scale * q
    cur = torch.stack([q, p, metric.velocity(p), g, metric.velocity(g)], dim=1).contiguous()
    f = dict(dtype=dtype, device=DEVICE)
    st = SimpleNamespace(
        cur=cur, s_prop=cur.clone(), s_rho=torch.zeros(c, dim, **f),
        s_logp_prop=torch.zeros(c, **f), s_sum_accept=torch.zeros(c, **f),
        s_n_leaves=torch.zeros(c, **f), s_lsw=torch.full((c,), -torch.inf, **f),
        s_div=torch.zeros(c, dtype=torch.bool, device=DEVICE),
        s_turn=torch.zeros(c, dtype=torch.bool, device=DEVICE),
        # every 7th chain not alive (at two chains the second)
        alive=torch.as_tensor(np.arange(c) % 7 != (6 if c > 2 else 1), device=DEVICE),
        h0=0.5 * (scale * q * q).sum(-1) + 0.5 * (p * metric.velocity(p)).sum(-1),
        ckpts=torch.zeros(c, LEAF_ROWS, 3, dim, **f), s_div_edge=torch.zeros(c, dim, **f),
        s_div_leaf=torch.zeros(c, dim, **f), q=torch.zeros(2, c, dim, **f),
        counters=torch.zeros(3, dtype=torch.int32, device=DEVICE))
    signs = np.where(rng.random(c) < 0.5, -1.0, 1.0)
    eps = put(np.geomspace(0.01, 0.5, c) * signs if c > 1 else [0.05])
    u_leaf = put(rng.random((1 << LEAF_DEPTH, c)))
    return st, metric, eps, u_leaf, vg


_PER_LAUNCH = ("counters", "readout")


def _clone_state(st, idx=None):
    """A copy of a leaf state, of chains ``idx`` only where given (the pair
    counter and the readout are the launch's, not a chain's: copied whole; the q buffers hold the chains on
    their second axis)."""
    from types import SimpleNamespace

    def part(k, t):
        if idx is None or k in _PER_LAUNCH:
            return t
        return t[:, idx] if k == "q" else t[idx]

    return SimpleNamespace(**{k: part(k, t).clone() for k, t in vars(st).items()})


def _leaf_margins(plain_before, q_n, lp, mg, g, half, u, j, rows, tol):
    """The plain version's decision quantities in float64 and, per chain,
    whether each decision (bad, take, turned) is within ``tol`` of its
    threshold: there a flip is rounding, not a fault. Returns (flags of
    "near" per decision, the energy scale)."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.inference.nuts import (
        MAX_DELTA_ENERGY,
    )

    d = lambda t: t.double()  # noqa: E731
    _, p, v, g0, mg0 = plain_before.cur.unbind(1)
    p_n = d(p + half * g0) + d(half) * d(g)
    v_n = d(v + half * mg0) + d(half) * d(mg)
    kin = 0.5 * (p_n * v_n).sum(-1)
    h0 = d(plain_before.h0)
    scale = torch.maximum(torch.maximum(kin.abs(), h0.abs()), d(lp).abs().nan_to_num())
    delta = -d(lp) + kin - h0
    near_bad = (delta - MAX_DELTA_ENERGY).abs() <= tol * scale
    w = torch.where(delta <= MAX_DELTA_ENERGY, -delta, -torch.inf)
    lsw = torch.logaddexp(d(plain_before.s_lsw), w)
    near_take = (torch.log(d(u)) - (w - lsw)).abs() <= 4 * tol * scale
    near_turn = torch.zeros_like(near_bad)
    if j % 2:
        lo, hi = rows
        rho = d(plain_before.s_rho) + p_n
        for r in range(lo, hi + 1):
            rk, vk, rhok = (d(plain_before.ckpts[:, r, i]) for i in range(3))
            rc = rho - rhok + rk - 0.5 * (rk + p_n)
            for a, b in ((vk, rc), (rc, v_n)):
                near_turn |= (a * b).sum(-1).abs() <= tol * (a * b).abs().sum(-1)
    return dict(bad=near_bad, take=near_take, turned=near_turn), scale


def _leaf_check(name, dtype, tol):
    """L2 against its plain version from the same inputs at every leaf of a
    depth-LEAF_DEPTH sub-tree (the kernel's state restarts from the plain one
    at each leaf; each leaf's q the plain drift of the state, as D1 and L2
    write it), both with the pair counter (L2 takes the leaf index from it).
    L2 runs from a CUDA graph; on an odd leaf with a WHILE node on the
    handle it sets, whose body (ops/graph_if.probe, limit 0) runs once if
    the condition holds, so the body's count reads the condition L2 set.
    The next leaf's q that L2 writes must be the plain drift
    (``leaf_drift_torch``, on the card) of the state L2 committed, bit for
    bit, for every chain. Returns (max abs errors of the next q and of L2's
    leaf state, flags that differ, of them outside the margin, the decisions
    seen, the odd leaves whose condition was read, the chains whose q_next
    differs from the drift's, the not-alive chain-leaves whose q_next was
    checked)."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.inference.nuts import (
        MAX_DELTA_ENERGY, _leaf_idx_to_ckpt_idxs,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.ops import graph_if as gi
    from manifold_constrained_gaussian_process_inference_tpu_torch.ops import leaf

    plain, metric, eps, u_leaf, vg = _leaf_case(name, dtype)
    half, step = (0.5 * eps)[:, None], eps[:, None]
    errs, differ, outside = [0.0, 0.0], Counter(), Counter()
    seen = Counter()
    launches = dict(leaf.LAUNCHES)
    loops = gi.WhileNodes(DEVICE)
    ran = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    never = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    conditions = next_differ = frozen = 0
    for j in range(1 << LEAF_DEPTH):
        rows = _leaf_idx_to_ckpt_idxs(j)
        plain.s_div.zero_()  # the kernel's state starts from the plain one, flags lowered
        plain.s_turn.zero_()
        before = _clone_state(plain)
        kern = _clone_state(plain)
        q_n = leaf.leaf_drift_torch(plain.cur, half, step)
        lp, g = vg(q_n)
        mg = metric.velocity(g)
        leaf.leaf_commit_torch(plain, metric, half, step, q_n, plain.q[1], lp, g, u_leaf, j, rows,
                               MAX_DELTA_ENERGY, True, plain.counters)
        inv_mass = metric.diagonal()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            ran.zero_()
            handle = loops.handle() if j % 2 else None
            leaf.leaf_commit_cuda(kern, half, step, q_n, kern.q[1], lp, g,
                                  None if inv_mass is not None else mg, inv_mass, u_leaf, j % 2,
                                  MAX_DELTA_ENERGY, True, handle)
            if handle is not None:
                loops.loop(handle, lambda: gi.probe(handle, ran, never))
        graph.replay()
        # L2's next q against the plain drift of the state L2 committed,
        # every chain
        l1 = leaf.leaf_drift_torch(kern.cur, half, step)
        torch.cuda.synchronize()
        errs[0] = max(errs[0], _max_err(kern.q[1], l1))
        same = (kern.q[1] == l1) | (kern.q[1].isnan() & l1.isnan())
        next_differ += int((~same.all(-1)).sum())
        frozen += int((~before.alive).sum())
        near, scale = _leaf_margins(before, q_n, lp, mg, g, half, u_leaf[j], j, rows, tol)
        alive0 = before.alive
        took = {s: (st.s_prop != before.s_prop).flatten(1).any(1) for s, st in
                (("plain", plain), ("kern", kern))}
        near_any = near["bad"] | near["take"] | near["turned"]
        flags = dict(take=(took["plain"], took["kern"]), bad=(plain.s_div, kern.s_div),
                     turned=(plain.s_turn, kern.s_turn), alive=(plain.alive, kern.alive))
        agree = torch.ones_like(alive0)
        for what, (a, b) in flags.items():
            diff = alive0 & (a != b)
            differ[what] += int(diff.sum())
            outside[what] += int((diff & ~near_any).sum())
            agree &= ~diff
            seen[what] += int((alive0 & a).sum())
        # the pair counter, and the condition L2 set (where no chain's alive
        # flag flipped within its margin): in counters[2] and in its handle
        k, arrived, cond = kern.counters.tolist()
        check(k == plain.counters[0].item() == (j + 1) // 2 and arrived == 0,
              f"leaf {name} {dtype} leaf {j}: counters {kern.counters.tolist()}, plain "
              f"{plain.counters.tolist()}")
        if j % 2 and torch.equal(plain.alive, kern.alive):
            want = int(plain.counters[2].item())
            check(cond == want and int(ran.item()) == want,
                  f"leaf {name} {dtype} leaf {j}: condition {cond}, through the handle "
                  f"{int(ran.item())}, plain {want}")
            conditions += 1
        # the state of the chains whose decisions agree: rows relative to
        # their largest magnitude, the energy sums to the energy scale
        for key in ("cur", "s_prop", "s_rho", "ckpts", "s_div_edge", "s_div_leaf",
                    "s_lsw", "s_sum_accept", "s_logp_prop", "s_n_leaves", "q"):
            a, b = getattr(kern, key), getattr(plain, key)
            a, b = (a[1][agree], b[1][agree]) if key == "q" else (a[agree], b[agree])
            fin = torch.isfinite(b)
            check(torch.equal(fin, torch.isfinite(a)) and torch.equal(
                a[~fin].nan_to_num(), b[~fin].nan_to_num()),
                f"leaf {name} {dtype} leaf {j}: {key} differs in its non-finite entries")
            if not fin.any():
                continue
            err = float((a[fin] - b[fin]).abs().max())
            if key == "cur":
                errs[1] = max(errs[1], err)
            ref = (float(scale[agree].max()) if key in ("s_lsw", "s_sum_accept")
                   else float(b[fin].abs().max()))
            check(err <= tol * max(ref, 1.0) if key in ("s_lsw", "s_sum_accept")
                  else err <= tol * ref,
                  f"leaf {name} {dtype} leaf {j}: {key} max abs err {err:.3e} (scale {ref:.3e})")
    made = {k: leaf.LAUNCHES[k] - launches[k] for k in launches}
    check(made == {leaf.OPEN: 0, leaf.COMMIT: 1 << LEAF_DEPTH, leaf.MERGE: 0},
          f"leaf {name}: {made} launches for {1 << LEAF_DEPTH} leaves")
    return errs, dict(differ), dict(outside), dict(seen), conditions, next_differ, frozen


def _leaf_sub_batches(dtype):
    """Each chain's bits at LEAF_SUBSETS' chain counts against its rows of a
    LEAF_SHAPES["slice"] launch, L2 at every leaf of the sub-tree (writing
    the next leaf's q, which the next leaf reads; leaf 0's the plain drift,
    as D1 writes it), each launch with its own pair counter, which must
    advance alike."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.inference.nuts import (
        MAX_DELTA_ENERGY,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.ops import leaf

    full, metric, eps, u_leaf, vg = _leaf_case("slice", dtype)
    half, step = (0.5 * eps)[:, None], eps[:, None]
    same = True
    subs = {n: (torch.as_tensor(idx, device=DEVICE), _clone_state(full, list(idx)))
            for n, idx in LEAF_SUBSETS.items()}
    for j in range(1 << LEAF_DEPTH):
        q_n, q_next = full.q[j % 2], full.q[1 - j % 2]
        if j == 0:
            leaf.leaf_drift_torch(full.cur, half, step, out=q_n)
            for idx, sub in subs.values():
                leaf.leaf_drift_torch(sub.cur, half[idx], step[idx], out=sub.q[0])
        lp, g = vg(q_n)
        mg = metric.velocity(g)
        for idx, sub in subs.values():
            same &= torch.equal(sub.q[j % 2], q_n[idx])
            leaf.leaf_commit_cuda(sub, half[idx], step[idx], sub.q[j % 2], sub.q[1 - j % 2],
                                  lp[idx].contiguous(), g[idx].contiguous(), mg[idx].contiguous(),
                                  None, u_leaf[:, idx].contiguous(), j % 2,
                                  MAX_DELTA_ENERGY, True)
        leaf.leaf_commit_cuda(full, half, step, q_n, q_next, lp, g, mg, None, u_leaf, j % 2,
                              MAX_DELTA_ENERGY, True)
        for idx, sub in subs.values():
            same &= bool(sub.counters[0] == full.counters[0])  # the pair counter
            for k in vars(full):
                if k == "counters":
                    continue
                a, b = getattr(sub, k), getattr(full, k)
                b = b[:, idx] if k == "q" else b[idx]
                same &= torch.equal(a, b) if a.dtype == torch.bool else (
                    torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(),
                                                                      b.nan_to_num()))
    return same


def _leaf_kernel_times(name):
    """Device ms per launch of L2 and of its plain version at
    LEAF_SHAPES[name] in float32, each from a replayed CUDA graph of
    LEAF_REPS launches over the sub-tree's leaves in turn (every chain alive
    and taking: alive set before each launch and L2's pair counter zeroed
    before each sub-tree, whose own time is taken out; the uniforms 0, no
    divergent chain), with the bound of each from the bytes it must move at
    3.35 TB/s. L2 runs in device-counter mode, as in the tree (an odd leaf's
    arrivals and condition included); its plain version with the host's
    j."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.inference.nuts import (
        MAX_DELTA_ENERGY, _leaf_idx_to_ckpt_idxs,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.ops import leaf

    st, metric, eps, _, vg = _leaf_case(name, torch.float32)
    c, dim, kind = LEAF_SHAPES[name]
    half, step = (0.5 * eps)[:, None], eps[:, None]
    q_n, q_next = st.q[0], st.q[1]
    leaf.leaf_drift_torch(st.cur, half, step, out=q_n)
    lp, g = vg(q_n)
    mg = metric.velocity(g)
    inv_mass = metric.diagonal()
    given = metric if inv_mass is not None else _GivenVelocity(mg)
    u_zero = torch.zeros((1 << LEAF_DEPTH, c), dtype=torch.float32, device=DEVICE)
    js = [k % (1 << LEAF_DEPTH) for k in range(LEAF_REPS)]
    launches = dict(leaf.LAUNCHES)

    def timed(body):
        body()  # warm-up (allocations, first launch)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for j in js:
                body(j)
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / len(js)

    def prepare(j=0):
        st.alive.fill_(True)
        if j == 0:
            st.counters.zero_()

    def commit_kernel(j=0):
        prepare(j)
        leaf.leaf_commit_cuda(st, half, step, q_n, q_next, lp, g,
                              None if inv_mass is not None else mg, inv_mass, u_zero, j % 2,
                              MAX_DELTA_ENERGY, False)

    def commit_plain(j=0):
        prepare(j)
        leaf.leaf_commit_torch(st, given, half, step, q_n, q_next, lp, g, u_zero, j,
                               _leaf_idx_to_ckpt_idxs(j), MAX_DELTA_ENERGY, False)

    fill = timed(prepare)
    out = {"commit": dict(ms=timed(commit_kernel) - fill, plain_ms=timed(commit_plain) - fill)}
    metric_kind = "shared" if kind == "shared" else ("diag" if kind == "diag" else "dense")
    out["commit"]["bound_ms"] = float(np.mean([leaf.commit_bytes(
        c, dim, 4, j, _leaf_idx_to_ckpt_idxs(j), c, c, 0, metric_kind, False) for j in js])
    ) / HBM_BYTES_PER_MS
    for k in out.values():
        k.update(bound_by="bytes", library_ms=None)
    for name_k in launches:  # timing launches are not a path's
        leaf.LAUNCHES[name_k] = launches[name_k]
    return out


def _graph_ms(fn, reps=LEAF_REPS) -> float:
    """Device ms of one fn() from a replayed CUDA graph of ``reps`` calls."""
    fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class _OpLog(TorchDispatchMode):
    """The aten operations run inside the block."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _product_check():
    """The dense metric's product (csrc/minv_mv.cu, ops/minv_mv.py) against
    its plain version in float64 at PRODUCT_SHAPES: float64 within
    PRODUCT_TOL_F64 of the largest output, float32 no further from it than
    torch.matmul's float32 product; each chain's bits at LEAF_SUBSETS' chain
    counts equal its rows of the 128-chain launch, both dtypes; the
    preparation of minv and of its transpose (the strided view the
    whitening GEMM g_psi W hands it) bit-equal to its plain version, both
    dtypes; a
    dense metric's velocity on the card issues no matmul; ms per launch at
    PRODUCT_TIMED beside the plain version (torch.matmul), the first design
    and the bound, and the preparation's at [slice]'s dim beside its plain
    version and bytes bound. Returns (the lines, [slice]'s float32 error,
    the timings, the preparation's error and timing)."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.inference.nuts import (
        DenseMetric,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.ops import cuda_band, minv_mv

    pr13 = ctypes.CDLL(str(cuda_band.build(
        Path(__file__).resolve().parent / PRODUCT_BASELINE))).minv_mv_f32
    pr13.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    pr13.restype = ctypes.c_int

    def run_pr13(m, x, out):
        if pr13(m.data_ptr(), x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
                torch.cuda.current_stream().cuda_stream):
            raise SmokeFailure("product: the first design's kernel failed to launch")
        return out

    launches = dict(minv_mv.LAUNCHES)
    parts, errs, times, same, prep_err, prep_time = [], {}, {}, True, 0.0, None
    for k, (name, (c, dim)) in enumerate(PRODUCT_SHAPES.items()):
        rng = np.random.default_rng(100 + k)
        a = rng.normal(size=(dim, dim)) / np.sqrt(dim)
        minv = 0.3 * a @ a.T + np.eye(dim) + 1e-3 * rng.normal(size=(dim, dim))  # not symmetric
        g = rng.normal(size=(c, dim))
        want = torch.as_tensor(g) @ torch.as_tensor(minv).T  # float64, on the host
        scale = float(want.abs().max())
        row = {}
        for dtype in (torch.float64, torch.float32):
            m, x = (torch.as_tensor(v, dtype=dtype, device=DEVICE) for v in (minv, g))
            prep = minv_mv.prepare(m)
            for op, got_op in ((m, prep), (m.T, minv_mv.prepare(m.T))):  # W^T: a strided view
                plain_op = minv_mv.prepare_torch(op)
                prep_err = max(prep_err, float((got_op - plain_op).abs().max()))
                check(torch.equal(got_op, plain_op),
                      f"product {name}: the prepared operand of a {tuple(op.stride())}-strided "
                      f"minv differs from its plain version ({dtype})")
            if name == "slice" and dtype == torch.float32:
                moved = 4 * dim * dim + 8 * minv_mv.prepared_size(dim)
                prep_time = dict(ms=_graph_ms(lambda: minv_mv.prepare(m, prep)),
                                 plain_ms=_graph_ms(lambda: minv_mv.prepare_torch(m)),
                                 library_ms=None, bound_ms=moved / HBM_BYTES_PER_MS,
                                 bound_by="bytes", shape=[dim, dim])
            got = minv_mv.minv_mv_cuda(m, x)
            err = float((got.cpu().double() - want).abs().max())
            if dtype == torch.float64:
                row["f64_rel"] = err / scale
                check(err <= PRODUCT_TOL_F64 * scale,
                      f"product {name}: float64 error {err:.3e} of {scale:.3e}")
            else:
                lib = float(((x @ m.T).cpu().double() - want).abs().max())
                row.update(f32=err, f32_matmul=lib)
                errs[name] = err
                check(err <= lib, f"product {name}: float32 error {err:.3e} over torch.matmul's "
                      f"{lib:.3e}")
            if c == N_CHAINS:
                for idx in LEAF_SUBSETS.values():
                    same &= torch.equal(minv_mv.minv_mv_cuda(m, x[list(idx)]), got[list(idx)])
            if name in PRODUCT_TIMED and dtype == torch.float32:
                flop, nbytes = minv_mv.product_work(c, dim, 4)
                plain = _graph_ms(lambda: minv_mv.minv_mv_torch(m, x))
                out = torch.empty_like(x)
                times[name] = dict(
                    ms=_graph_ms(lambda: minv_mv.minv_mv_cuda(m, x)), plain_ms=plain,
                    pr13_ms=_graph_ms(lambda: run_pr13(m, x, out)),
                    library_ms=plain, bound_ms=max(flop / FP32_FLOP_PER_MS,
                                                   nbytes / HBM_BYTES_PER_MS),
                    bound_by="operations" if flop / FP32_FLOP_PER_MS > nbytes / HBM_BYTES_PER_MS
                    else "bytes", shape=[c, dim])
        ranges, per = minv_mv.split(dim)
        parts.append(f"{name} ({c}, {dim}; {ranges} k ranges of {per} steps): float64 rel "
                     f"{row['f64_rel']:.2e}, float32 {row['f32']:.2e} (torch.matmul "
                     f"{row['f32_matmul']:.2e})")
    m = torch.eye(8, device=DEVICE) + 0.1
    with _OpLog() as log:
        DenseMetric(m, m, m).velocity(torch.ones(4, 8, device=DEVICE))
    mm = [op for op in log.ops if any(w in op for w in ("mm", "matmul", "linear", "dot"))]
    check(not mm, f"product: a dense metric's velocity on the card ran {mm}")
    check(same, "product: a chain's bits depend on the launch's chain count")
    for name_k in launches:  # checking and timing launches are not a path's
        minv_mv.LAUNCHES[name_k] = launches[name_k]
    line = ("the dense metric's product minv_mv (csrc/minv_mv.cu) vs the float64 plain version: "
            + "; ".join(parts) + f"; a chain's bits at C = {list(LEAF_SUBSETS)} equal its rows of "
            f"the {N_CHAINS}-chain launch: {same}; velocity on the card runs no matmul "
            f"({len(log.ops)} aten ops); the prepared operand of minv and of minv^T bit-equal to "
            f"its plain version at every shape; ms per launch (float32, graph of {LEAF_REPS}) kernel / torch.matmul / "
            "the first design / bound: " + ", ".join(
                f"{n} {v['ms']:.5f} / {v['plain_ms']:.5f} / {v['pr13_ms']:.5f} / "
                f"{v['bound_ms']:.5f} ({v['bound_by']})" for n, v in times.items())
            + f"; the preparation at dim {PRODUCT_SHAPES['slice'][1]} {prep_time['ms']:.5f} / plain "
            f"{prep_time['plain_ms']:.5f} / bound {prep_time['bound_ms']:.5f} (bytes)")
    return line, errs["slice"], times, prep_err, prep_time


def phase_leaf():
    """[leaf]: the NUTS leaf's kernels (csrc/nuts_leaf.cu) against their
    plain versions on the card at LEAF_SHAPES and LEAF_STASH_SHAPES, float64
    and float32, L2 in device-counter mode; a chain's bits at LEAF_SUBSETS'
    chain counts; device times at LEAF_SHAPES."""
    errs, parts, conditions = {}, [], 0
    for name, (c, _, _) in {**LEAF_SHAPES, **LEAF_STASH_SHAPES}.items():
        for dtype, tol in ((torch.float64, TOL_F64), (torch.float32, TOL_F32)):
            e, differ, outside, seen, n_cond, next_differ, frozen = _leaf_check(name, dtype, tol)
            errs[name, dtype] = e
            conditions += n_cond
            parts.append(f"{name} {({**LEAF_SHAPES, **LEAF_STASH_SHAPES})[name]} "
                         f"{str(dtype)[6:]}: max abs err next q {e[0]:.2e}, L2 state {e[1]:.2e}; "
                         f"flags differing {differ} (outside the margin {outside}); decisions "
                         f"seen {seen}; L2's next q bit-equal to the plain drift of its "
                         f"committed state {not next_differ} ({frozen} chain-leaves not alive)")
            check(not any(outside.values()),
                  f"leaf {name} {dtype}: decisions differ outside their margin {outside}")
            check(next_differ == 0 and (c == 1 or frozen > 0),
                  f"leaf {name} {dtype}: L2's next q differs from the drift's on {next_differ} "
                  f"chain-leaves ({frozen} not alive)")
            if c > 2:
                check(seen.get("take", 0) and seen.get("bad", 0) and seen.get("turned", 0),
                      f"leaf {name} {dtype}: decisions not all seen {seen}")
    same = {str(dtype)[6:]: _leaf_sub_batches(dtype) for dtype in (torch.float64, torch.float32)}
    times = {name: _leaf_kernel_times(name) for name in LEAF_SHAPES}
    product_line, product_err, product_times, prep_err, prep_time = _product_check()
    t = times["slice"]
    print("[leaf] L2 nuts_leaf_commit (csrc/nuts_leaf.cu) vs its plain version over a "
          f"depth-{LEAF_DEPTH} sub-tree, track_div_leaf on, L2 with the pair counter: "
          + "; ".join(parts)
          + f"; the pair counter equal at every leaf, the condition L2 set (read through a WHILE "
          f"node on its handle) equal to the plain version's at {conditions} odd leaves; a "
          f"chain's bits at C = {list(LEAF_SUBSETS)} equal its rows of a "
          f"{LEAF_SHAPES['slice'][0]}-chain launch: {same}; ms per launch (float32, graph of "
          f"{LEAF_REPS}) kernel / plain / bytes bound, L2 beside its time without the drift: "
          + ", ".join(f"{n} L2 {v['commit']['ms']:.5f} / "
                      f"{v['commit']['plain_ms']:.5f} / {v['commit']['bound_ms']:.5f} (without "
                      f"{LEAF_PREVIOUS_COMMIT_MS[n]:.5f})"
                      for n, v in times.items())
          + f"; L2 at slice within the target {LEAF_COMMIT_TARGET_MS} ms: "
          f"{t['commit']['ms'] <= LEAF_COMMIT_TARGET_MS}; " + product_line, flush=True)
    check(all(same.values()), f"leaf: a chain's bits depend on the launch's chain count {same}")
    max_err = {"commit": errs["slice", torch.float32][1], "product": product_err,
               "prepare": prep_err}
    timing = {"commit": {**t["commit"], **{n: v["commit"] for n, v in times.items()
                                           if n != "slice"}}}
    timing["product"] = {**product_times["slice"],
                         **{n: v for n, v in product_times.items() if n != "slice"}}
    timing["prepare"] = prep_time
    return max_err, timing


def _doubling_case(name, dtype, track, depth):
    """[doubling]'s inputs at one of LEAF_SHAPES: [leaf]'s sub-tree state
    with the trajectory's buffers around it (both edges, the proposal and
    rho drawn at random, log_sum_w and the sums spread, one chain's
    log_sum_w -inf, every DOUBLING_DONE-th chain done), the step sizes, the
    doubling's uniforms u (2, C) and its depth; with ``track`` the tracked
    divergent step's buffers."""
    st, metric, eps, _, _ = _leaf_case(name, dtype)
    c, dim = st.cur.shape[0], st.cur.shape[2]
    rng = np.random.default_rng(1000 + LEAF_SEEDS[name] + 10 * depth + 100 * track)
    put = lambda a: torch.as_tensor(a, dtype=dtype, device=DEVICE)  # noqa: E731
    f = dict(dtype=dtype, device=DEVICE)
    st.left, st.right, st.prop = (put(rng.normal(size=(c, 5, dim))) for _ in range(3))
    st.rho = put(rng.normal(size=(c, dim)))
    st.logp_prop = put(rng.normal(size=c))
    lsw = rng.normal(size=c)
    lsw[c // 2] = -np.inf
    st.log_sum_w = put(lsw)
    st.sum_accept, st.num_leaves = put(rng.uniform(0, 5, size=c)), put(rng.integers(0, 9, c))
    st.diverging = torch.zeros(c, dtype=torch.bool, device=DEVICE)
    st.done = torch.as_tensor(np.arange(c) % DOUBLING_DONE == DOUBLING_DONE - 1, device=DEVICE)
    st.depth = torch.zeros(c, dtype=torch.int32, device=DEVICE)
    st.eps = eps.abs()
    st.half, st.step = torch.zeros(c, **f), torch.zeros(c, **f)
    st.readout = torch.zeros(2, dtype=torch.int64, device=DEVICE)
    st.div_edge, st.div_leaf = torch.zeros(c, dim, **f), torch.zeros(c, dim, **f)
    if not track:
        del st.s_div_edge, st.s_div_leaf, st.div_edge, st.div_leaf
    return st, put(rng.random((2, c))), rng


def _subtree_end(st, rng, k):
    """A sub-tree's end written over an opened state (the plain and the
    kernel's alike): the last leaf, the proposal, rho, the sums and weights
    drawn at random, every DOUBLING_DIV-th chain divergent and every
    DOUBLING_TURN-th turned (not where done), one chain's weights -inf, the
    pair counter at k."""
    c, _, dim = st.cur.shape
    put = lambda a: torch.as_tensor(a, dtype=st.cur.dtype, device=DEVICE)  # noqa: E731
    st.cur.copy_(put(rng.normal(size=(c, 5, dim))))
    st.s_prop.copy_(put(rng.normal(size=(c, 5, dim))))
    st.s_rho.copy_(put(rng.normal(size=(c, dim))))
    lsw = rng.normal(size=c) + 0.5
    lsw[c // 3] = -np.inf
    st.s_lsw.copy_(put(lsw))
    st.s_logp_prop.copy_(put(rng.normal(size=c)))
    st.s_sum_accept.copy_(put(rng.uniform(0, 4, size=c)))
    st.s_n_leaves.copy_(put(rng.integers(1, 8, size=c)))
    idx = np.arange(c)
    st.s_div.copy_(torch.as_tensor(idx % DOUBLING_DIV == 1, device=DEVICE) & ~st.done)
    st.s_turn.copy_(torch.as_tensor(idx % DOUBLING_TURN == 2, device=DEVICE) & ~st.done)
    if hasattr(st, "s_div_edge"):
        st.s_div_edge.copy_(put(rng.normal(size=(c, dim))))
        st.s_div_leaf.copy_(put(rng.normal(size=(c, dim))))
    st.counters.zero_()
    st.counters[0] = k


def _turn_margin(st, u, tol):
    """Per chain, whether either row dot of the merged trajectory's U-turn
    check lies within ``tol`` of 0 (relative to the sum of its terms' sizes),
    in float64 from the merge's inputs: there a flipped done is rounding."""
    d = lambda t: t.double()  # noqa: E731
    right = (u[0] < 0.5)[:, None]
    p_l = torch.where(right, d(st.left[:, 1]), d(st.cur[:, 1]))
    v_l = torch.where(right, d(st.left[:, 2]), d(st.cur[:, 2]))
    p_r = torch.where(right, d(st.cur[:, 1]), d(st.right[:, 1]))
    v_r = torch.where(right, d(st.cur[:, 2]), d(st.right[:, 2]))
    rc = d(st.rho) + d(st.s_rho) - 0.5 * (p_l + p_r)
    near = torch.zeros(st.done.shape, dtype=torch.bool, device=DEVICE)
    for a in (v_l, v_r):
        near |= (a * rc).sum(-1).abs() <= tol * (a * rc).abs().sum(-1)
    return near


def _same(a, b) -> bool:
    """Bit-equal, NaN where NaN."""
    if a.dtype in (torch.bool, torch.int32, torch.int64):
        return torch.equal(a, b)
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())


def _max_err(a, b) -> float:
    """Largest |a - b| over the entries finite in both (0 for flags)."""
    if a.dtype in (torch.bool, torch.int32, torch.int64) or not a.numel():
        return 0.0
    fin = torch.isfinite(a) & torch.isfinite(b)
    return float((a[fin] - b[fin]).abs().max()) if fin.any() else 0.0


def _doubling_check(name, dtype, track, depth, tol):
    """D1 and D2 against their plain versions from the same state: D1's
    every buffer bit-equal to the plain opening's (its steps to the plain
    version's returned ones; leaf 0's q to leaf_drift_torch of the edge);
    D2's every buffer bit-equal but the done flags, which may differ only
    within their margin (``_turn_margin``), the readout's leaves 2k (1 at
    depth 0) and the arrivals reset. Returns a dict: done flips, of them
    outside the margin, the chains updated, valid and taken, D1's and D2's
    max abs errors and whether each was bit-equal."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.ops import leaf

    st, u, rng = _doubling_case(name, dtype, track, depth)
    n_leaves = 1 << depth
    plain, kern = _clone_state(st), _clone_state(st)
    own = ("half", "step")  # D1's steps, which the plain opening returns
    half, step = leaf.doubling_open_torch(plain, u, n_leaves, track)
    k_half, k_step = leaf.doubling_open_cuda(kern, u, n_leaves, track)
    torch.cuda.synchronize()
    pairs = [(k_half, half), (k_step, step),
             (kern.q[0], leaf.leaf_drift_torch(plain.cur, half, step))] + [
        (getattr(kern, key), getattr(plain, key)) for key in vars(plain) if key not in own]
    out = dict(open_same=all(_same(a, b) for a, b in pairs),
               open_err=max(_max_err(a, b) for a, b in pairs))
    check(out["open_same"], f"doubling {name} {dtype} depth {depth} track {track}: D1 differs "
          "from the plain opening in " + str([key for key in vars(plain) if key not in own
                                              and not _same(getattr(kern, key),
                                                            getattr(plain, key))]))
    k = 0 if depth == 0 else int(rng.integers(1, n_leaves // 2 + 1))
    _subtree_end(plain, rng, k)
    for key in vars(plain):
        getattr(kern, key).copy_(getattr(plain, key))
    near = _turn_margin(plain, u, tol)
    upd = ~plain.done
    valid = upd & ~(plain.s_div | plain.s_turn)
    taken = valid & (u[1] < torch.exp(torch.clamp(plain.s_lsw - plain.log_sum_w, max=0.0)))
    leaf.doubling_merge_torch(plain, u, n_leaves, depth + 1, track)
    leaf.doubling_merge_cuda(kern, u, n_leaves, depth + 1, track)
    torch.cuda.synchronize()
    flips = kern.done != plain.done
    pairs = [(getattr(kern, key), getattr(plain, key)) for key in vars(plain)
             if key not in ("readout", "counters", "done") + own]
    pairs.append((kern.done[~flips], plain.done[~flips]))
    out.update(merge_same=all(_same(a, b) for a, b in pairs),
               merge_err=max(_max_err(a, b) for a, b in pairs),
               flips=int(flips.sum()), outside=int((flips & ~near).sum()), updated=int(upd.sum()),
               valid=int(valid.sum()), taken=int(taken.sum()))
    want_leaves = 1 if depth == 0 else 2 * k
    read = kern.readout.tolist()
    check(read[1] == want_leaves and kern.counters[1].item() == 0 and (
        bool(flips.any()) or read == plain.readout.tolist()),
        f"doubling {name} {dtype} depth {depth}: readout {read}, plain "
        f"{plain.readout.tolist()}, leaves run {want_leaves}, arrivals {kern.counters[1].item()}")
    return out


def _doubling_sub_batches(dtype):
    """Each chain's bits at LEAF_SUBSETS' chain counts against its rows of a
    LEAF_SHAPES["slice"] launch, D1 and then D2 (track on, depth 3), every
    buffer but the per-launch ones."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.ops import leaf

    full, u, rng = _doubling_case("slice", dtype, True, 3)
    subs = {n: (list(idx), _clone_state(full, list(idx))) for n, idx in LEAF_SUBSETS.items()}

    def rows(key, t, idx):
        return t[:, idx] if key == "q" else t[idx]

    leaf.doubling_open_cuda(full, u, 8, True)
    for idx, sub in subs.values():
        leaf.doubling_open_cuda(sub, u[:, idx].contiguous(), 8, True)
    same = all(_same(getattr(sub, key), rows(key, t, idx)) for idx, sub in subs.values()
               for key, t in vars(full).items() if key not in _PER_LAUNCH)
    _subtree_end(full, rng, 3)
    for idx, sub in subs.values():
        for key, t in vars(full).items():
            getattr(sub, key).copy_(t if key in _PER_LAUNCH else rows(key, t, idx))
    leaf.doubling_merge_cuda(full, u, 8, 4, True)
    for idx, sub in subs.values():
        leaf.doubling_merge_cuda(sub, u[:, idx].contiguous(), 8, 4, True)
    return same and all(_same(getattr(sub, key), rows(key, t, idx))
                        for idx, sub in subs.values() for key, t in vars(full).items()
                        if key not in _PER_LAUNCH)


def _doubling_times(name):
    """Device ms per launch of D1 and D2 and of their plain versions at
    LEAF_SHAPES[name] in float32 (track off, depth 3), each from a replayed
    CUDA graph of LEAF_REPS launches; D2's and the plain merge's with the
    done flags reset before each launch, whose own time is taken out; the
    bound of each from the bytes its data needs at 3.35 TB/s."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.ops import leaf

    st, u, rng = _doubling_case(name, torch.float32, False, 3)
    c, _, dim = st.cur.shape
    leaf.doubling_open_torch(st, u, 8, False)
    _subtree_end(st, rng, 4)
    done0 = st.done.clone()
    upd = ~done0
    valid = upd & ~(st.s_div | st.s_turn)
    taken = valid & (u[1] < torch.exp(torch.clamp(st.s_lsw - st.log_sum_w, max=0.0)))

    def reset():
        st.done.copy_(done0)

    def merge_kernel():
        reset()
        leaf.doubling_merge_cuda(st, u, 8, 4, False)

    def merge_plain():
        reset()
        leaf.doubling_merge_torch(st, u, 8, 4, False)

    fill = _graph_ms(reset)
    out = {  # the merges first: an opening resets the sub-tree's state
        "merge": dict(ms=_graph_ms(merge_kernel) - fill, plain_ms=_graph_ms(merge_plain) - fill,
                      bound_ms=leaf.merge_bytes(c, dim, 4, int(upd.sum()), int(valid.sum()),
                                                int(taken.sum()), int((upd & st.s_div).sum()),
                                                False) / HBM_BYTES_PER_MS),
        "open": dict(ms=_graph_ms(lambda: leaf.doubling_open_cuda(st, u, 8, False)),
                     plain_ms=_graph_ms(lambda: leaf.doubling_open_torch(st, u, 8, False)),
                     bound_ms=leaf.open_bytes(c, dim, 4, False) / HBM_BYTES_PER_MS),
    }
    for k in out.values():
        k.update(bound_by="bytes", library_ms=None, shape=[c, dim])
    return out


def phase_doubling():
    """[doubling]: the doubling's opening D1 and merge D2 (csrc/nuts_leaf.cu)
    against their plain versions on the card at LEAF_SHAPES and
    LEAF_STASH_SHAPES' dims, float64 and float32, track on and off, at
    DOUBLING_DEPTHS; a chain's bits at LEAF_SUBSETS' chain counts; device
    times at LEAF_SHAPES beside the plain versions and the bytes bound."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.ops import leaf

    launches = dict(leaf.LAUNCHES)
    parts, seen, errs = [], Counter(), {}
    for name in {**LEAF_SHAPES, **LEAF_STASH_SHAPES}:
        row = Counter()
        for dtype, tol in ((torch.float64, TOL_F64), (torch.float32, TOL_F32)):
            for track in (False, True):
                for depth in DOUBLING_DEPTHS:
                    r = _doubling_check(name, dtype, track, depth, tol)
                    check(r["merge_same"], f"doubling {name} {dtype} depth {depth} track {track}: "
                          f"D2's state differs from the plain merge's (max abs err "
                          f"{r['merge_err']:.3e})")
                    row.update({key: r[key] for key in ("flips", "outside", "updated", "valid",
                                                        "taken")})
                    for key in ("open", "merge"):
                        errs[key] = max(errs.get(key, 0.0), r[f"{key}_err"])
        seen.update(row)
        parts.append(f"{name} {({**LEAF_SHAPES, **LEAF_STASH_SHAPES})[name]}: {dict(row)}")
    check(seen["outside"] == 0, f"doubling: {seen['outside']} done flags differ outside their "
          "margin")
    check(seen["taken"] > 0 and seen["valid"] > seen["taken"] and seen["updated"] > seen["valid"],
          f"doubling: decisions not all seen {dict(seen)}")
    same = {str(dtype)[6:]: _doubling_sub_batches(dtype) for dtype in (torch.float64, torch.float32)}
    check(all(same.values()), f"doubling: a chain's bits depend on the launch's chain count {same}")
    for key in launches:  # checking launches are not a path's
        leaf.LAUNCHES[key] = launches[key]
    times = {name: _doubling_times(name) for name in LEAF_SHAPES}
    for key in launches:  # nor timing ones
        leaf.LAUNCHES[key] = launches[key]
    print("[doubling] D1 nuts_doubling_open and D2 nuts_doubling_merge (csrc/nuts_leaf.cu) vs "
          f"their plain versions, float64 and float32, track off and on, depths "
          f"{list(DOUBLING_DEPTHS)}: D1 bit-equal (leaf 0's q = leaf_drift_torch of the edge), "
          f"D2 bit-equal but done, whose flips are all within their margin; max abs err D1 "
          f"{errs['open']:.2e}, D2 {errs['merge']:.2e}; per shape (done flips, of them outside "
          "the margin, chains updated, valid, taken): " + "; ".join(parts)
          + f"; a chain's bits at C = {list(LEAF_SUBSETS)} equal its rows of the "
          f"{LEAF_SHAPES['slice'][0]}-chain launch: {same}; ms per launch (float32, graph of "
          f"{LEAF_REPS}) kernel / plain / bytes bound: " + ", ".join(
              f"{n} D1 {v['open']['ms']:.5f} / {v['open']['plain_ms']:.5f} / "
              f"{v['open']['bound_ms']:.5f}, "
              f"D2 {v['merge']['ms']:.5f} / {v['merge']['plain_ms']:.5f} / "
              f"{v['merge']['bound_ms']:.5f}" for n, v in times.items()), flush=True)
    timing = {k: {**times["slice"][k], **{n: v[k] for n, v in times.items() if n != "slice"}}
              for k in ("open", "merge")}
    return errs, timing



@contextlib.contextmanager
def _eager_tree():
    """The eager tree (the CPU path's) on the card, for every sampler made
    inside the block."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.inference import (
        nuts_batched as nb,
    )

    real = nb.tree_graphed
    nb.tree_graphed = lambda device, vg_b: False
    try:
        yield
    finally:
        nb.tree_graphed = real


def _differing(a: dict, b: dict) -> list:
    """Keys of two results' diagnostics whose values differ (times and the
    host counts that differ by design left out)."""
    out = []
    for key, x in a.items():
        if "time" in key or "seconds" in key or key in TREE_HOST_COUNTS or key not in b:
            continue
        y = b[key]
        if isinstance(x, (np.ndarray, int, float, np.number)):
            x, y = np.asarray(x), np.asarray(y)
            same = x.shape == y.shape and (
                np.array_equal(x, y, equal_nan=True) if x.dtype.kind == "f"
                else np.array_equal(x, y))
            if not same:
                out.append(key)
    return out


def phase_tree(mt, y, t):
    """[slice]'s recipe, [default], [pt] and [envelope] at TREE_NITER, each
    through solve_magi on the graphed tree and on the eager one, each run's
    doubling-kernel launches held to one D1 and one D2 per doubling and one L2 per batched
    leaf."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.models import (
        HES1LOG_FIXF_SYSTEM,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.perf.workload import (
        fn_bench_workload, hes1_workload,
    )

    from manifold_constrained_gaussian_process_inference_tpu_torch.ops import cuda_band

    t_h, y_h, _ = hes1_workload(seed=PT_SEED)
    y_d, t_d = fn_bench_workload(seed=DEFAULT_SEED)
    n_env = TREE_NITER["envelope"]
    cases = {
        "slice": (mt.FN_SYSTEM, y, t, mt.MagiConfig(**slice_config(TREE_NITER["slice"]))),
        "default": (mt.FN_SYSTEM, y_d, t_d, dataclasses.replace(
            default_config(mt, TREE_NITER["default"]), verbose=False)),
        "pt": (HES1LOG_FIXF_SYSTEM, y_h, t_h, mt.MagiConfig(**{
            **pt_config(), "niter_hmc": TREE_NITER["pt"],
            "map_init_iterations": TREE_PT_MAP_ITERS}, band_impl="band", device=DEVICE)),
        "envelope": (mt.FN_SYSTEM, y, t, mt.MagiConfig(**{
            **slice_config(n_env), "burnin_ratio": (TREE_ENVELOPE_ADAPTS + 0.5) / n_env,
            "step_jitter": 0.0, "chunk_size": ENVELOPE_CHUNK}, divergence_envelope=True)),
    }
    counted = _Launches(cuda_band)
    parts, failed = [], []
    for name, (system, yy, tt_, config) in cases.items():
        runs = {}
        for kind in ("graphed", "eager"):
            with _eager_tree() if kind == "eager" else contextlib.nullcontext():
                counted.reset_launches()
                t0 = time.perf_counter()
                res = mt.solve_magi(yy, tt_, system, config)
                runs[kind] = (res, time.perf_counter() - t0)
                d = res.diagnostics
                fn = name in ("slice", "envelope")  # [slice]'s recipe: dense, whitened FN
                _leaf_launches(counted.counts(), d["lockstep_leaves"], d["doublings"],
                               f"tree {name} {kind}", d["transitions"] if fn else None,
                               (N_CHAINS, SLICE_DIM) if fn else None, kind == "eager")
        (g, g_wall), (e, e_wall) = runs["graphed"], runs["eager"]
        gd, ed = g.diagnostics, e.diagnostics
        diff = [f for f in ("theta", "x_sampled", "sigma", "lp")
                if not np.array_equal(getattr(g, f), getattr(e, f), equal_nan=True)]
        diff += _differing(gd, ed)
        lp_g, lp_e = np.asarray(gd["lp_per_chain"]), np.asarray(ed["lp_per_chain"])
        bad = np.nonzero(~np.all((lp_g == lp_e) | (np.isnan(lp_g) & np.isnan(lp_e)),
                                 axis=tuple(range(lp_g.ndim - 1))))[0] if lp_g.ndim else []
        ms = [1e3 * (r.diagnostics["phase_times_s"]["warmup_s"]
                     + r.diagnostics["phase_times_s"]["sampling_s"]) / r.diagnostics[
                         "lockstep_leaves"] for r in (g, e)]
        for d in (gd, ed):
            _route(d, f"tree {name}", TREE_ROUTES[name])
        parts.append(
            f"{name} ({config.niter_hmc} iterations, route {gd['vg_route']}): bit-equal "
            f"{not diff}"
            + (f" (differ: {diff}; first differing sampling draw {int(bad[0]) if len(bad) else None})"
               if diff else "")
            + f", {gd['transitions']} transitions, {gd['lockstep_leaves']} batched leaves "
            f"({gd['lockstep_leaves'] / gd['transitions']:.1f} per transition); graphed "
            f"{_host_reads(gd, f'tree {name}')}, eager host reads/transition "
            f"{ed['tree_reads'] / ed['transitions']:.3f}; ms per batched leaf graphed "
            f"{ms[0]:.4f} vs eager {ms[1]:.4f}; wall {g_wall:.1f} vs {e_wall:.1f} s")
        if diff:
            failed.append(name)
        check(ed["tree_reads"] > gd["tree_reads"], f"tree {name}: the eager run read no more")
    depths = _tree_capture_depths()
    print("[tree] graphed vs eager tree through solve_magi on the card: " + "; ".join(parts)
          + "; " + depths, flush=True)
    check(not failed, f"tree: the graphed and eager trees differ on {failed}")


def _tree_capture_depths() -> str:
    """Every depth of a graphed [slice] tree (N_CHAINS chains, the replayed
    value-and-grad of perf/tree_graphs.py) captured up front: each depth
    holds min(2^i, 4) leaves, from depth 2 under one WHILE node; per depth
    the capture seconds and the pools' MiB, and one transition on them."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.inference.nuts import (
        DenseMetric,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.parallel.chains import (
        GraphedValueAndGrad,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.perf.tree_graphs import (
        STEP_RANGE, capture_all_depths,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.perf.workload import (
        fn_bench_workload, slice_likelihood,
    )

    y, t = fn_bench_workload()
    lik = slice_likelihood(y, t, 20)
    dim = lik.dimension
    f = dict(dtype=torch.float32, device=DEVICE)
    q0 = torch.as_tensor(0.5 * np.random.default_rng(0).normal(size=(N_CHAINS, dim)), **f)
    eye = torch.eye(dim, **f)
    out = capture_all_depths(
        GraphedValueAndGrad(lik.vg("band"), q0), q0,
        torch.as_tensor(np.geomspace(*STEP_RANGE, N_CHAINS), **f), DenseMetric(eye, eye, eye),
        TREE_DEPTHS, torch.Generator(device=DEVICE).manual_seed(7))
    g = out["graphs"]
    for i, info in g.items():
        check(info["captured_leaves"] == min(1 << i, 4) and info["while_nodes"] == int(i >= 2),
              f"tree: depth {i} captured {info['captured_leaves']} leaves, "
              f"{info['while_nodes']} WHILE nodes")
    check(out["transition_ok"], "tree: a transition on the captured graphs is not finite")
    return (f"{TREE_DEPTHS} depths of a {N_CHAINS}-chain [slice] tree captured up front: leaves "
            f"captured {[info['captured_leaves'] for info in g.values()]}, WHILE nodes "
            f"{sum(info['while_nodes'] for info in g.values())}, nodes per doubling graph "
            f"{[info['nodes'] + info['body_nodes'] for info in g.values()]}, capture s "
            f"{[round(info['capture_s'], 3) for info in g.values()]} (total "
            f"{out['capture_s']:.3f}), pool MiB {[round(info['pool_bytes'] / 2**20, 1) for info in g.values()]}, "
            f"device MiB {out['device_bytes'] / 2**20:.1f}")


def _per_vg(launches, vg_evals, what, chains, route, one_chain_evals=0):
    """Launches per value-and-grad of one main path's run (entry points and
    tiles, as ``cuda_band.counts`` gives them), which must be exactly
    LAUNCHES_PER_VG of its value-and-grad's ``route``, each K1 launch on the
    tile that its value-and-grad's chains run (``_tile_kind``): ``chains``
    chains, but one chain in the first ``one_chain_evals`` (a MAP warm
    start's, whose raw target launches K1 as the autograd route does)."""
    for name, k in LAUNCHES_PER_VG[route].items():
        check(launches[name] == k * vg_evals,
              f"{what}: {name} {launches[name]} launches in {vg_evals} value-and-grads on the "
              f"{route} route, want {k} each")
    per_eval = sum(LAUNCHES_PER_VG[route][name] for name in KERNELS)
    want = {"row": 0, "chain": 0}
    want[_tile_kind(1)] += per_eval * one_chain_evals
    want[_tile_kind(chains)] += per_eval * (vg_evals - one_chain_evals)
    got = {kind: sum(k for name, k in launches.items() if name.startswith(kind + "_"))
           for kind in want}
    check(got == want, f"{what}: launches by tile kind {got}, want {want} ({chains} chains)")
    return {name: k / vg_evals for name, k in launches.items()}


def _route(d, what, want) -> str:
    """A solve_magi result's value-and-grad route (``vg_route``), which
    must be ``want``."""
    check(d["vg_route"] == want, f"{what}: value-and-grad route {d['vg_route']}, want {want}")
    return want


def _tile_kind(chains: int) -> str:
    """The kind of K1 tile ("row" or "chain") that ``cuda_band.tile_for``
    gives a launch of ``chains`` chains (the kind does not depend on the
    band or the dtype)."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.ops import cuda_band as cb

    return cb.tile_for(chains, 0, torch.float32).split("_")[0]


def _leaf_times(d):
    """ms per batched leapfrog step (sampler wall over batched leaves; the
    whole step: the replayed value-and-grad and the NUTS bookkeeping) and
    leaves/s of a solve_magi result's diagnostics."""
    pt = d["phase_times_s"]
    nuts_s = pt["warmup_s"] + pt["sampling_s"]
    return 1e3 * nuts_s / d["lockstep_leaves"], d["lockstep_leaves"] / nuts_s


def phase_diag_gauss():
    """The diag driver on an independent Gaussian with log-spaced scales:
    Welford adaptation on the device, independent of MAGI."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.parallel.chains import (
        run_chains,
    )

    scales = np.logspace(-2.0, 1.0, GAUSS_DIM)
    inv_var = torch.as_tensor(1.0 / scales**2, dtype=torch.float32, device="cuda")

    def vg(q):
        g = -q * inv_var
        return 0.5 * (g * q).sum(-1), g

    parts = []
    for c in GAUSS_CHAINS:
        q0 = np.random.default_rng(c).normal(size=(c, GAUSS_DIM)) * scales
        t0 = time.perf_counter()
        samples, info = run_chains(
            vg, torch.as_tensor(q0, dtype=torch.float32, device="cuda"),
            torch.Generator(device="cuda").manual_seed(c), n_samples=GAUSS_NITER,
            n_adapts=GAUSS_NITER // 2, initial_step_size=0.01, target_accept=0.8,
            mass_matrix="diag", chunk_size=GAUSS_NITER // 2, max_depth=GAUSS_MAX_DEPTH,
        )
        wall = time.perf_counter() - t0
        var_err = np.abs(samples.reshape(-1, GAUSS_DIM).astype(np.float64).var(0) / scales**2 - 1.0)
        mass = info["inv_mass"] / scales**2
        lo, hi = GAUSS_MASS_RANGE
        share = ((mass >= lo) & (mass <= hi)).mean(axis=1)
        check(np.isfinite(samples).all(), f"diag-gauss C={c}: non-finite draws")
        check(np.median(var_err) <= GAUSS_VAR_TOL,
              f"diag-gauss C={c}: median |var/scale^2 - 1| {np.median(var_err):.3f}")
        check(share.min() >= GAUSS_MASS_SHARE,
              f"diag-gauss C={c}: inv_mass/scale^2 in {GAUSS_MASS_RANGE} for {share.min():.3f}")
        nuts_s = info["warmup_time_s"] + info["sampling_time_s"]
        parts.append(
            f"C={c}: wall {wall:.1f} s, median |var/scale^2 - 1| {np.median(var_err):.4f}, "
            f"inv_mass/scale^2 in [{lo}, {hi}] for {share.min():.4f} (worst chain), step size "
            f"{np.round(info['step_size'], 4).tolist()}, {info['lockstep_leaves']} batched leaves "
            f"({1e3 * nuts_s / info['lockstep_leaves']:.3f} ms each), "
            f"{_host_reads(info, f'diag-gauss C={c}')}, sampling accept "
            f"{info['accept_prob'].mean():.3f}, sampling tree depth mean "
            f"{info['tree_depth'].mean():.2f}"
        )
    print(f"[diag-gauss] dim={GAUSS_DIM}, scales log-spaced over [0.01, 10], {GAUSS_NITER} "
          f"iterations ({GAUSS_NITER // 2} warmup), tree depth <= {GAUSS_MAX_DEPTH}, float32: "
          + "; ".join(parts), flush=True)


def default_config(mt, niter: int):
    """[default]'s MagiConfig at ``niter`` iterations: the library's
    defaults plus the FN example's settings, on the band kernels."""
    return mt.MagiConfig(
        niter_hmc=niter, burnin_ratio=0.5, step_size_factor=0.06,
        target_accept_ratio=0.8, jitter=1e-6, prior_temperature=(1.0, 1.0, 5.0),
        seed=DEFAULT_SEED, band_impl="band", device="cuda", verbose=True,
    )


def _start_psi_check(y, t, config):
    """solve_magi's start Psi (NLML phi and sigma, interpolated x,
    bounds-midpoint theta) on the default path: the float32 band
    value-and-grad of one chain on the card against float64 dense on the
    CPU."""
    import manifold_constrained_gaussian_process_inference_tpu_torch as mt
    from manifold_constrained_gaussian_process_inference_tpu_torch.inference.nlml import (
        optimize_gp_hyperparameters,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.inference.solve import (
        _init_theta_from_bounds, _init_x_interpolation,
    )

    opt = optimize_gp_hyperparameters(y, t, config.kernel, jitter=config.jitter,
                                      max_iters=config.gp_optim_iterations)
    phi, sigma = opt[:, :2].T, np.maximum(opt[:, 2], 1e-8)
    psi0 = np.concatenate([_init_x_interpolation(y, t).T.reshape(-1),
                           _init_theta_from_bounds(mt.FN_SYSTEM), np.log(sigma)])
    cov64 = mt.build_gp_cov(config.kernel, phi, t, bandsize=config.band_size,
                            jitter=config.jitter)
    vals = {}
    for impl, dtype, device in (("band", torch.float32, "cuda"), ("dense", torch.float64, "cpu")):
        target = mt.MagiTarget.build(y, cov64.to(dtype=dtype, device=device), mt.FN_SYSTEM,
                                     sigma, config.prior_temperature, False, band_impl=impl)
        v, g = target.value_and_grad_fn()(torch.as_tensor(psi0[None], dtype=dtype, device=device))
        vals[impl] = (v.double().cpu().numpy(), g.double().cpu().numpy())
    (v32, g32), (v64, g64) = vals["band"], vals["dense"]
    err = (float(np.abs(v32 - v64).max() / np.abs(v64).max()),
           float(np.abs(g32 - g64).max() / np.abs(g64).max()))
    check(np.isfinite(v32).all() and np.isfinite(g32).all(), "default: non-finite start vg")
    check(err[0] <= DEFAULT_TOL_VALUE and err[1] <= DEFAULT_TOL_GRAD,
          f"default: float32 start value-and-grad vs float64: value rel {err[0]:.3e}, grad "
          f"{err[1]:.3e} of max |grad|")
    return err, float(v64[0]), float(np.abs(g64).max())


def phase_default(mt, cb):
    """solve_magi at the library's defaults (one chain, diag, raw Psi) on
    the FN example's workload, with the band kernels."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.parallel.chains import (
        GRAPH_WARMUP_CALLS,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.perf.workload import (
        THETA_TRUE, fn_bench_workload,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.postprocess.diagnostics import (
        ess,
    )

    y, t = fn_bench_workload(seed=DEFAULT_SEED)
    config = default_config(mt, DEFAULT_NITER)
    check(config.n_chains == 1 and config.mass_matrix == "diag" and not config.x_whitened
          and config.map_init_iterations == 0, "default: MagiConfig defaults changed")
    err, v64, gmax = _start_psi_check(y, t, config)
    cb.reset_launches()
    t0 = time.perf_counter()
    res = mt.solve_magi(y, t, mt.FN_SYSTEM, config)
    wall = time.perf_counter() - t0
    launches = cb.counts()
    d = res.diagnostics
    vg_evals = GRAPH_WARMUP_CALLS + 1 + d["lockstep_leaves"]
    leaf_ms, leaves_s = _leaf_times(d)
    pt = d["phase_times_s"]
    n_keep = DEFAULT_NITER // 2
    accept = float(d["accept_prob"].mean())
    div_share = float(d["diverging"].mean())
    tpc = d["theta_per_chain"]
    ess_theta = [ess(tpc[:, :, j]) for j in range(tpc.shape[-1])]
    depth_hist = np.bincount(d["tree_depth"].ravel(), minlength=config.max_tree_depth + 1)
    print(f"[default] niter_hmc={DEFAULT_NITER} chains=1 mass_matrix={config.mass_matrix} raw Psi "
          f"band_impl={d['band_impl']} bandsize={d['bandsize']} dtype={d['dtype']} dim="
          f"{d['final_psi'].shape[-1]}; start Psi: float32 band vs float64 dense CPU value rel "
          f"{err[0]:.3e} (lp {v64:.6g}), grad {err[1]:.3e} of max |grad| {gmax:.4g}; wall "
          f"{wall:.1f} s: nlml {pt['nlml_s']:.2f} s, warmup {pt['warmup_s']:.2f} s, sampling "
          f"{pt['sampling_s']:.2f} s; {d['lockstep_leaves']} leaves "
          f"({d['lockstep_leaves'] / d['transitions']:.1f} per transition), {leaf_ms:.4f} ms per "
          f"leaf, {leaves_s:.0f} leaves/s; {_host_reads(d, 'default')}, all host syncs/transition "
          f"{d['host_syncs'] / d['transitions']:.2f}; sampling tree depths (0..10) "
          f"{depth_hist.tolist()}; step size {float(d['step_size'][0]):.5g}; accept {accept:.4f}; "
          f"divergent {div_share:.3f}; theta ESS {np.round(ess_theta, 1).tolist()}; theta mean "
          f"{np.round(res.theta.mean(0), 4).tolist()} (true {THETA_TRUE.tolist()}); sigma mean "
          f"{np.round(res.sigma.mean(0), 4).tolist()}; route {d['vg_route']}, kernel "
          f"launches {launches} in {vg_evals} "
          f"value-and-grads", flush=True)
    for name in ("theta", "x_sampled", "sigma", "lp"):
        check(np.isfinite(getattr(res, name)).all(), f"default: non-finite {name}")
    check(res.x_sampled.shape == (n_keep, 397, 2), "default: x_sampled shape")
    check(d["band_impl"] == "band", f"default: band_impl {d['band_impl']}")
    check(DEFAULT_ACCEPT[0] <= accept <= DEFAULT_ACCEPT[1], f"default: accept {accept:.4f}")
    check(div_share <= DEFAULT_MAX_DIVERGENT_SHARE, f"default: divergent share {div_share:.3f}")
    _leaf_launches(launches, d["lockstep_leaves"], d["doublings"], "default")
    return launches, _per_vg(launches, vg_evals, "default", config.n_chains,
                             _route(d, "default", "raw")), leaf_ms


def phase_families(mt, cb):
    """The JAX package's model-family end-to-end workloads on the card in
    float32, under that test's assertions. "auto" runs them on band (the
    layout sweep's rule at their grids); each run's K1 launches are read
    around its solve_magi: exactly LAUNCHES_PER_VG per value-and-grad (the
    MAP warm start's and the sampler's), all on the row tile (one chain).
    Returns the path's launches and launches per value-and-grad."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.parallel.chains import (
        GRAPH_WARMUP_CALLS,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.perf.workload import (
        FAMILY_CASES, family_problem,
    )

    parts, runs = [], []
    for name, case in FAMILY_CASES.items():
        system, y, t, options = family_problem(name)
        config = mt.MagiConfig(device="cuda", **options)
        cb.reset_launches()
        t0 = time.perf_counter()
        res = mt.solve_magi(y, t, system, config)
        wall = time.perf_counter() - t0
        launches = cb.counts()
        n_keep = options["niter_hmc"] // 2
        check(res.theta.shape == (n_keep, system.theta_size), f"{name}: theta shape")
        for what in ("theta", "x_sampled", "lp"):
            check(np.isfinite(getattr(res, what)).all(), f"{name}: non-finite {what}")
        if case["positive"]:
            check(bool((res.theta > 0).all()), f"{name}: theta not positive")
        d = res.diagnostics
        # the MAP warm start's value-and-grads (start, one per Adam step,
        # end) and the sampler's (graph warm-up, start, one per leaf)
        vg_evals = config.map_init_iterations + 2 + GRAPH_WARMUP_CALLS + 1 + d["lockstep_leaves"]
        runs.append((name, d, launches, vg_evals, config.mass_matrix == "dense-pooled"))
        parts.append(f"{name} (n={len(t)}, D={y.shape[1]}, k={system.theta_size}, "
                     f"band_impl={d['band_impl']}, bandsize={d['bandsize']}) {wall:.1f} s, "
                     f"map {d['phase_times_s']['map_s']:.2f} s, accept "
                     f"{d['accept_prob'].mean():.3f}, tree depth mean {d['tree_depth'].mean():.2f}, "
                     f"{_host_reads(d, name)}, "
                     f"theta mean {np.round(res.theta.mean(0), 4).tolist()} "
                     f"(true {case['theta']}); route {d['vg_route']}, kernel launches "
                     f"{launches} in {vg_evals} value-and-grads")
    print("[families] float32 on the card: " + "; ".join(parts), flush=True)
    total, total_evals = Counter(), 0
    for name, d, launches, vg_evals, dense in runs:
        check(d["band_impl"] == "band", f"families {name}: band_impl {d['band_impl']}")
        _per_vg(launches, vg_evals, f"families {name}", 1,
                _route(d, f"families {name}", "raw"))
        _leaf_launches(launches, d["lockstep_leaves"], d["doublings"], f"families {name}",
                       d["transitions"] if dense else None)
        total.update(launches)
        total_evals += vg_evals
    return dict(total), {name: k / total_evals for name, k in total.items()}, None


def phase_slice(mt, cb, y, t):
    from manifold_constrained_gaussian_process_inference_tpu_torch.parallel.chains import (
        GRAPH_WARMUP_CALLS,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.perf.workload import (
        SIGMA_TRUE, THETA_TRUE,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.postprocess.diagnostics import (
        ess,
    )

    config = mt.MagiConfig(**slice_config(NITER_HMC), verbose=True)
    cb.reset_launches()
    t0 = time.perf_counter()
    res = mt.solve_magi(y, t, mt.FN_SYSTEM, config)
    wall = time.perf_counter() - t0
    launches = cb.counts()
    d = res.diagnostics
    tpc = d["theta_per_chain"]
    ess_min = min(ess(tpc[:, :, j]) for j in range(tpc.shape[-1]))
    rhat_max = max_rhat(tpc)
    theta_rmse = rmse(res.theta.mean(0), THETA_TRUE)
    sigma_rmse = rmse(res.sigma.mean(0), SIGMA_TRUE)
    pt = d["phase_times_s"]
    nuts_s = pt["warmup_s"] + pt["sampling_s"]
    device_evals = d["lockstep_leaves"] * N_CHAINS
    # the sampler's value-and-grad evaluations on the card: the graph's
    # eager warm-up calls, the start positions and one per batched leaf
    vg_evals = GRAPH_WARMUP_CALLS + 1 + d["lockstep_leaves"]
    leaf_ms, leaves_s = _leaf_times(d)
    depth_hist = np.bincount(d["tree_depth"].ravel(), minlength=config.max_tree_depth + 1)
    print(f"[slice] niter_hmc={NITER_HMC} chains={N_CHAINS} band_impl={d['band_impl']} "
          f"bandsize={d['bandsize']} dtype={d['dtype']}; wall {wall:.1f} s: nlml "
          f"{pt['nlml_s']:.2f} s, gn_map {pt['gn_map_s']:.2f} s, hessian+whitener "
          f"{pt['whitener_s']:.2f} s, warmup {pt['warmup_s']:.2f} s, sampling "
          f"{pt['sampling_s']:.2f} s; batched value-and-grad evals/s "
          f"{device_evals / nuts_s:.0f} (useful sampling leapfrogs/s "
          f"{d['gradient_evals'] / pt['sampling_s']:.0f}); {leaf_ms:.4f} ms per batched leaf, "
          f"{leaves_s:.0f} leaves/s, {d['lockstep_leaves'] / d['transitions']:.1f} per "
          f"transition; {_host_reads(d, 'slice')}, all host syncs/transition "
          f"{d['host_syncs'] / d['transitions']:.2f}; sampling "
          f"tree depths (0..10, chains x draws) {depth_hist.tolist()}; min-theta ESS "
          f"{ess_min:.1f}, ESS/s "
          f"{ess_min / wall:.3f} (total wall); max R-hat {rhat_max:.4f}; theta mean "
          f"{np.round(res.theta.mean(0), 4).tolist()} RMSE {theta_rmse:.4f}; sigma RMSE "
          f"{sigma_rmse:.4f}; divergences {d['n_divergent']}; route {d['vg_route']}, kernel "
          f"launches {launches} in "
          f"{vg_evals} value-and-grads", flush=True)
    for name in ("theta", "x_sampled", "sigma", "lp"):
        check(np.isfinite(getattr(res, name)).all(), f"non-finite {name}")
    check(res.x_sampled.shape == (N_CHAINS * (NITER_HMC // 2), 397, 2), "x_sampled shape")
    check(d["band_impl"] == "band", f"band_impl {d['band_impl']}")
    check(d["bandsize"] == MAIN_BANDSIZE, f"bandsize {d['bandsize']} != {MAIN_BANDSIZE}")
    per_vg = _per_vg(launches, vg_evals, "slice", N_CHAINS, _route(d, "slice", "kernel"))
    _leaf_launches(launches, d["lockstep_leaves"], d["doublings"], "slice", d["transitions"],
                   (N_CHAINS, SLICE_DIM))
    check(theta_rmse <= THETA_RMSE_MAX, f"theta RMSE {theta_rmse:.4f}")
    check(sigma_rmse <= SIGMA_RMSE_MAX, f"sigma RMSE {sigma_rmse:.4f}")
    check(rhat_max <= RHAT_MAX, f"max R-hat {rhat_max:.4f}")
    return launches, per_vg, leaf_ms


def _health(d):
    """Sampling accept rate and divergent share of a result's diagnostics."""
    return float(d["accept_prob"].mean()), float(d["diverging"].mean())


def _stale_ladder_gap(built, temperatures, n_rep):
    """Max relative gap between the run's tempered value-and-grad (replayed
    from its CUDA graph) at the start positions it was captured with and
    the raw value there times the run's final ladder."""
    vg, _, example, vg_t = built
    want = vg(example)[0] * torch.as_tensor(np.tile(1.0 / temperatures, n_rep),
                                            dtype=example.dtype, device=example.device)
    got = vg_t(example)[0]
    return float(((got - want).abs().max() / want.abs().max()).cpu())


def phase_pt(mt, cb):
    """Config 3 through solve_magi with sampler="pt-nuts"."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.inference import (
        tempering as tt,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.models import (
        HES1LOG_FIXF_SYSTEM,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.parallel.chains import (
        GraphedValueAndGrad,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.perf.workload import (
        HES1_THETA_TRUE_FIXF, hes1_workload,
    )

    t_grid, y, x_truth = hes1_workload(seed=PT_SEED)
    config = mt.MagiConfig(**pt_config(), band_impl="band", device="cuda", verbose=True)
    # keep the run's tempered value-and-grad to read it after the run
    real_tempered, built = tt._tempered_vg, []

    def keep(vg, beta, example):
        out = real_tempered(vg, beta, example)
        built.append((vg, beta, example, out[0]))
        return out

    tt._tempered_vg = keep
    try:
        cb.reset_launches()
        t0 = time.perf_counter()
        res = mt.solve_magi(y, t_grid, HES1LOG_FIXF_SYSTEM, config)
        wall = time.perf_counter() - t0
        launches = cb.counts()
    finally:
        tt._tempered_vg = real_tempered
    d = res.diagnostics
    check(len(built) == 1 and isinstance(built[0][3], GraphedValueAndGrad),
          "pt: the tempered value-and-grad is not replayed from a CUDA graph")
    start_ladder = tt.auto_ladder(config.pt_temps, d["final_psi"].shape[-1])
    check(not np.allclose(d["temperatures"], start_ladder), "pt: the ladder did not adapt")
    graph_gap = _stale_ladder_gap(built[0], d["temperatures"], config.pt_replicas)
    # the MAP warm start's value-and-grads (start, one per Adam step, end)
    # and the sampler's (PT counts its own: start, graph warm-up, leaves)
    vg_evals = config.map_init_iterations + 2 + d["vg_evals"]
    n_chains = config.pt_temps * config.pt_replicas
    pt = d["phase_times_s"]
    nuts_s = pt["warmup_s"] + pt["sampling_s"]
    leaf_ms = 1e3 * nuts_s / d["lockstep_leaves"]
    batched = d["lockstep_leaves"] / d["transitions"]
    per_chain = d["chain_leaves"] / (n_chains * d["transitions"])
    theta_rmse = rmse(res.theta.mean(0), HES1_THETA_TRUE_FIXF)
    h_rmse = rmse(res.x_sampled[:, :, 2].mean(0), x_truth[:, 2])
    accept, div_share = _health(d)
    swap = float(d["swap_acceptance"])
    print(f"[pt] config 3: n={len(t_grid)} D=3 dim={d['final_psi'].shape[-1]} rungs="
          f"{config.pt_temps} replicas={config.pt_replicas} ({n_chains} batched chains) "
          f"niter_hmc={PT_NITER} band_impl={d['band_impl']} bandsize={d['bandsize']} "
          f"dtype={d['dtype']}; wall {wall:.1f} s: map {pt['map_s']:.2f} s, gn_map "
          f"{pt['gn_map_s']:.2f} s, whitener {pt['whitener_s']:.2f} s, warmup "
          f"{pt['warmup_s']:.2f} s, "
          f"sampling {pt['sampling_s']:.2f} s; {d['lockstep_leaves']} batched leaves, "
          f"{leaf_ms:.4f} ms per batched leaf; leaves per transition batched {batched:.1f} vs "
          f"mean per chain {per_chain:.1f}; {_host_reads(d, 'pt')}, all host syncs/transition "
          f"{d['host_syncs'] / d['transitions']:.2f}; final ladder T "
          f"{np.round(d['temperatures'], 4).tolist()}; swap acceptance {swap:.3f} per pair "
          f"{np.round(d['swap_acceptance_per_pair'], 3).tolist()}; cold-rung accept {accept:.4f}, "
          f"divergent {div_share:.4f}; step sizes (cold rungs) "
          f"{np.round(np.asarray(d['step_size'])[:, 0], 5).tolist()}; theta mean "
          f"{np.round(res.theta.mean(0), 4).tolist()} RMSE {theta_rmse:.4f}; unobserved-H RMSE "
          f"{h_rmse:.4f}; replayed tempered value vs raw x final ladder {graph_gap:.3e}; "
          f"route {d['vg_route']}, kernel "
          f"launches {launches} in {vg_evals} value-and-grads", flush=True)
    for name in ("theta", "x_sampled", "lp"):
        check(np.isfinite(getattr(res, name)).all(), f"pt: non-finite {name}")
    check(d["band_impl"] == "band", f"pt: band_impl {d['band_impl']}")
    check(d["bandsize"] == PT_BANDSIZE, f"pt: bandsize {d['bandsize']} != {PT_BANDSIZE}")
    check(graph_gap <= PT_GRAPH_TOL,
          f"pt: replayed tempered value vs raw value x final ladder {graph_gap:.3e}")
    per_vg = _per_vg(launches, vg_evals, "pt", n_chains, _route(d, "pt", "autograd"),
                     config.map_init_iterations + 2)
    _leaf_launches(launches, d["lockstep_leaves"], d["doublings"], "pt")
    check(theta_rmse < THETA_RMSE_MAX, f"pt: theta RMSE {theta_rmse:.4f}")
    check(h_rmse < PT_H_RMSE_MAX, f"pt: unobserved-H RMSE {h_rmse:.4f}")
    check(PT_SWAP_RANGE[0] <= swap <= PT_SWAP_RANGE[1], f"pt: swap acceptance {swap:.3f}")
    check(PT_ACCEPT_RANGE[0] <= accept <= PT_ACCEPT_RANGE[1], f"pt: cold-rung accept {accept:.4f}")
    check(div_share <= PT_MAX_DIVERGENT_SHARE, f"pt: divergent share {div_share:.4f}")
    return launches, per_vg, leaf_ms


def phase_chees(mt, cb, y, t):
    """Config 7 through solve_magi with sampler="chees" (SNAPER)."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.perf.workload import (
        SEED, THETA_TRUE,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.postprocess.diagnostics import (
        ess,
    )

    config = mt.MagiConfig(**chees_config(y, t, SEED), band_impl="band", device="cuda",
                           verbose=True)
    cb.reset_launches()
    t0 = time.perf_counter()
    res = mt.solve_magi(y, t, mt.FN_SYSTEM, config)
    wall = time.perf_counter() - t0
    launches = cb.counts()
    d = res.diagnostics
    tpc = d["theta_per_chain"]
    rhat_max = max_rhat(tpc)
    ess_min = min(ess(tpc[:, :, j]) for j in range(tpc.shape[-1]))
    theta_rmse = rmse(res.theta.mean(0), THETA_TRUE)
    pt = d["phase_times_s"]
    step_ms = 1e3 * (pt["warmup_s"] + pt["sampling_s"]) / d["lockstep_leaves"]
    steps = d["num_leapfrog"][0]
    accept, div_share = _health(d)
    traj, eps = float(d["trajectory_length"]), float(d["step_size"])
    trace = d["trajectory_warmup_trace"]
    quarters = [float(trace[int(q * (len(trace) - 1))]) for q in (0.25, 0.5, 0.75, 1.0)]
    print(f"[chees] config 7: n={len(t)} chains={CHEES_CHAINS} SNAPER niter_hmc={CHEES_NITER} "
          f"band_impl={d['band_impl']} bandsize={d['bandsize']} dtype={d['dtype']}; wall "
          f"{wall:.1f} s: nlml {pt['nlml_s']:.2f} s, gn_map {pt['gn_map_s']:.2f} s, whitener "
          f"{pt['whitener_s']:.2f} s, warmup {pt['warmup_s']:.2f} s, sampling "
          f"{pt['sampling_s']:.2f} s; {d['lockstep_leaves']} leapfrog steps, {step_ms:.4f} ms "
          f"per step (all chains); n_steps per iteration "
          f"{d['lockstep_leaves'] / d['transitions']:.1f} "
          f"(sampling: mean {steps.mean():.1f}, min {steps.min()}, max {steps.max()}); "
          f"trajectory length {traj:.4f} (warmup T at 1/4, 1/2, 3/4, end "
          f"{np.round(quarters, 3).tolist()}), step size {eps:.5f}; accept {accept:.4f}, divergent "
          f"{div_share:.4f}; min-theta ESS {ess_min:.1f}, ESS/s {ess_min / wall:.3f} (total "
          f"wall); max R-hat {rhat_max:.4f}; theta mean {np.round(res.theta.mean(0), 4).tolist()} "
          f"RMSE {theta_rmse:.4f}; route {d['vg_route']}, kernel "
          f"launches {launches} in {d['vg_evals']} "
          f"value-and-grads", flush=True)
    for name in ("theta", "x_sampled", "lp"):
        check(np.isfinite(getattr(res, name)).all(), f"chees: non-finite {name}")
    check(d["band_impl"] == "band", f"chees: band_impl {d['band_impl']}")
    check(d["bandsize"] == MAIN_BANDSIZE, f"chees: bandsize {d['bandsize']} != {MAIN_BANDSIZE}")
    per_vg = _per_vg(launches, d["vg_evals"], "chees", CHEES_CHAINS,
                     _route(d, "chees", "kernel"))
    # ChEES runs no NUTS tree; its value-and-grad the whitening GEMMs
    _leaf_launches(launches, 0, 0, "chees", whitened=(CHEES_CHAINS, SLICE_DIM))
    check(theta_rmse <= THETA_RMSE_MAX, f"chees: theta RMSE {theta_rmse:.4f}")
    check(rhat_max <= CHEES_RHAT_MAX, f"chees: max R-hat {rhat_max:.4f} > {CHEES_RHAT_MAX}")
    check(np.isfinite(traj) and traj > eps, f"chees: trajectory length {traj} vs step {eps}")
    check(CHEES_ACCEPT_RANGE[0] <= accept <= CHEES_ACCEPT_RANGE[1], f"chees: accept {accept:.4f}")
    check(div_share <= CHEES_MAX_DIVERGENT_SHARE, f"chees: divergent share {div_share:.4f}")
    return launches, per_vg, step_ms


def phase_resume(mt):
    """Resumed ``solve_magi`` runs on the card against the uninterrupted
    ones, bit for bit: each chain's theta, x and lp. A small whitened FN
    problem (n=41, phi and sigma fixed) on the band kernels in float32. The
    checkpoint writer is wrapped to keep the checkpoint that a run killed
    there would have left, and the resumed call loads it from its file."""
    import tempfile

    from manifold_constrained_gaussian_process_inference_tpu_torch.inference import (
        checkpoint as ck, tempering as tt,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.perf.workload import (
        PHI, SIGMA_TRUE, fn_bench_workload,
    )

    y, t = fn_bench_workload(n_obs=21, t_end=8.0, fill=1)
    n_keep, more = RESUME_NITER // 2, RESUME_NITER // 2 - RESUME_CHUNK

    def kept_checkpoint(module, writer, want, config):
        real, kept = getattr(module, writer), {}

        def capture(path, ckpt):
            if "path" not in kept and want(ckpt):
                kept["path"] = f"{path}.kept.npz"
                real(kept["path"], ckpt)
            real(path, ckpt)

        setattr(module, writer, capture)
        try:
            res = mt.solve_magi(y, t, mt.FN_SYSTEM, config)
        finally:
            setattr(module, writer, real)
        check("path" in kept, f"resume: {config.sampler} wrote no checkpoint to keep")
        _route(res.diagnostics, f"resume {config.sampler}", "kernel")
        return res, kept["path"]

    def draws(res):
        d = res.diagnostics
        c = d["n_chains"]
        return (d["theta_per_chain"], d["lp_per_chain"],
                res.x_sampled.reshape(c, -1, *res.x_sampled.shape[1:]))

    def same(full, resumed, first, what):
        for name, a, b in zip(("theta", "lp", "x"), draws(full), draws(resumed)):
            a = a[:, first:]
            check(a.shape == b.shape and np.array_equal(a, b),
                  f"resume {what}: the resumed {name} differs from the uninterrupted run's")
        return draws(resumed)[0].shape

    parts = []
    with tempfile.TemporaryDirectory() as tmp:
        base = dict(niter_hmc=RESUME_NITER, burnin_ratio=0.5, chunk_size=RESUME_CHUNK, seed=5,
                    phi=PHI, sigma=np.full(2, SIGMA_TRUE), x_whitened=True, band_impl="band",
                    device="cuda", checkpoint_path=f"{tmp}/ckpt.npz")
        pooled = mt.MagiConfig(**base, n_chains=8, chain_init_jitter=0.05,
                               mass_matrix="dense-pooled", step_jitter=0.125)
        full, kept = kept_checkpoint(
            ck, "save_checkpoint",
            lambda c: c.phase == "warmup" and 0 < c.warmup["pos"] < RESUME_NITER // 2, pooled)
        pos = ck.load_checkpoint(kept).warmup["pos"]
        shape = same(full, mt.solve_magi(y, t, mt.FN_SYSTEM, pooled, resume=kept), 0,
                     "pooled NUTS warmup")
        parts.append(f"pooled NUTS killed at warmup iteration {pos} of {RESUME_NITER // 2}: "
                     f"{shape[0]} chains x {shape[1]} draws equal")
        cases = (
            ("diag NUTS", ck, "save_checkpoint", dict(n_chains=4, chain_init_jitter=0.05)),
            ("pooled PT (4 rungs x 2 replicas)", tt, "save_pt_checkpoint",
             dict(sampler="pt-nuts", pt_temps=4, pt_replicas=2, mass_matrix="dense-pooled")),
            ("ChEES", ck, "save_checkpoint",
             dict(sampler="chees", n_chains=16, chain_init_jitter=0.05)),
        )
        sampling = lambda c: getattr(c, "phase", "sampling") == "sampling"  # noqa: E731
        for what, module, writer, extra in cases:
            config = mt.MagiConfig(**base, **extra)
            full, kept = kept_checkpoint(module, writer, sampling, config)
            leg = dataclasses.replace(config, niter_hmc=more)
            shape = same(full, mt.solve_magi(y, t, mt.FN_SYSTEM, leg, resume=kept),
                         n_keep - more, what)
            parts.append(f"{what} resumed after {RESUME_CHUNK} draws: {shape[0]} chains x "
                         f"{shape[1]} draws equal")
    print(f"[resume] solve_magi(resume=checkpoint file) on the card, float32, whitened FN "
          f"n={len(t)}, route kernel (one centered_vg launch per value-and-grad); theta, x "
          f"and lp against the uninterrupted run: "
          + "; ".join(parts), flush=True)


def _mesh_solve(rank, mesh, y, t):
    """(a): solve_magi(mesh=...) on [slice]'s recipe at MESH_NITER; returns
    this rank's readings and the (target, whitener) it sampled."""
    import manifold_constrained_gaussian_process_inference_tpu_torch as mt
    from manifold_constrained_gaussian_process_inference_tpu_torch.inference.whiten import (
        make_centered_whitened_vg,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.ops import cuda_band
    from manifold_constrained_gaussian_process_inference_tpu_torch.parallel.chains import (
        GRAPH_WARMUP_CALLS,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.perf.workload import (
        SIGMA_TRUE, THETA_TRUE,
    )

    cb = _Launches(cuda_band)
    cb.reset_launches()
    t0 = time.perf_counter()
    res = mt.solve_magi(y, t, mt.FN_SYSTEM, mt.MagiConfig(**slice_config(MESH_NITER)),
                        mesh=mesh)
    wall = time.perf_counter() - t0
    launches = cb.counts()
    d = res.diagnostics
    pt = d["phase_times_s"]
    target, whitener = d["target"], d["whitener"]
    # what this rank sampled, before any gather: its target's tensors, its
    # whitener and their value-and-grad at a point common to every rank
    zeta = torch.as_tensor(np.random.default_rng(1).normal(
        scale=0.1, size=(N_CHAINS // mesh.size, target.dimension)), dtype=torch.float32,
        device=DEVICE)
    held = [a for a in (*target.data, target.sigma_init, *whitener,
                        *make_centered_whitened_vg(target, whitener)(zeta)) if torch.is_tensor(a)]
    return (target, whitener), dict(
        result=digest(res.theta, res.x_sampled, res.sigma, res.lp),
        adapted=digest(d["step_size"], d["inv_mass"]),
        sampled_on=digest(*(a.cpu().numpy() for a in held)), wall=wall, phase_times=pt,
        finite=all(np.isfinite(getattr(res, name)).all()
                   for name in ("theta", "x_sampled", "sigma", "lp")),
        theta_rmse=rmse(res.theta.mean(0), THETA_TRUE), sigma_rmse=rmse(res.sigma.mean(0),
                                                                        SIGMA_TRUE),
        rhat=max_rhat(d["theta_per_chain"]), divergent=float(d["diverging"].mean()),
        launches=launches, vg_evals=GRAPH_WARMUP_CALLS + 1 + d["lockstep_leaves"],
        leaves=d["lockstep_leaves"], transitions=d["transitions"],
        chain_leaves=d["chain_leaves"] / (N_CHAINS // mesh.size),
        leaf_ms=1e3 * (pt["warmup_s"] + pt["sampling_s"]) / d["lockstep_leaves"],
        bandsize=d["bandsize"], dim=int(d["final_psi"].shape[-1]), vg_route=d["vg_route"],
        reads={k: d[k] for k in ("tree_reads", "doublings", "transitions", "graph_capture_s")},
    )


def _float64_twin(target, whitener):
    """(a)'s whitened value-and-grad in float64 on the card: its float32
    data and whitener widened."""

    from manifold_constrained_gaussian_process_inference_tpu_torch.inference.whiten import (
        make_centered_whitened_vg,
    )

    wide = lambda f: f.double() if torch.is_tensor(f) and f.is_floating_point() else f  # noqa: E731
    consts = target.theta_consts
    target64 = dataclasses.replace(
        target, data=type(target.data)(*map(wide, target.data)), sigma_init=wide(target.sigma_init),
        theta_consts=None if consts is None else type(consts)(*map(wide, consts)))
    return make_centered_whitened_vg(target64, type(whitener)(*map(wide, whitener)))


def _in_row_blocks(vg, n_blocks):
    """``vg`` applied to ``n_blocks`` row blocks of its (C, dim) input: the
    batch each rank's value-and-grad sees under a mesh of ``n_blocks``."""
    def blocked(z):
        parts = [vg(block) for block in z.chunk(n_blocks)]
        return tuple(torch.cat(col) for col in zip(*parts))

    return blocked


def _mesh_dryrun(rank, mesh, vgs, dim, nccl_group):
    """(b) and (c): the JAX dry run's protocol, sharded over the mesh, on
    (a)'s whitened value-and-grad in float32 and in float64 (``vgs``); rank 0
    runs each call unsharded too, and (b)'s float32 run_chains call on a
    one-rank NCCL world. In float32 the whitening GEMM of the value-and-grad
    rounds a chain by the batch's size (cuBLAS picks kernels by shape), which
    a tree decision near its threshold can turn into another trajectory; in
    float64 it cannot. So float32 run_chains is also run unsharded with its
    value-and-grad applied in the ranks' row blocks, which the sharded run
    must equal bit for bit."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.inference.chees import (
        run_chees,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.inference.tempering import (
        make_replica_mesh, run_parallel_tempering,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.parallel import (
        CHAIN_AXIS, Mesh, run_chains,
    )

    gen = lambda seed: torch.Generator(device=DEVICE).manual_seed(seed)  # noqa: E731
    kw = dict(n_samples=3, n_adapts=1, initial_step_size=0.01, max_depth=4)
    calls = {
        "chains": lambda f, z, m: run_chains(f, z, gen(0), mass_matrix="dense-pooled", mesh=m,
                                             **kw),
        "pt": lambda f, z, m: run_parallel_tempering(
            f, z[0], gen(2), n_temps=3, max_temp=4.0, n_replicas=mesh.size,
            ladder_adapt=False, mass_matrix="dense-pooled", mesh=m, **kw),
        "chees": lambda f, z, m: run_chees(f, z[:CHEES_CHAINS], gen(3), n_samples=3,
                                           n_adapts=1, initial_step_size=0.01, mesh=m),
    }
    meshes = {"chains": mesh, "pt": make_replica_mesh(device=DEVICE), "chees": mesh}
    out = {}
    for dtype, vg in vgs.items():
        zeros = torch.zeros((N_CHAINS, dim), dtype=dtype, device=DEVICE)
        for name, call in calls.items():
            sharded = call(vg, zeros, meshes[name])[0]
            out[f"{name}_{dtype}_digest"] = digest(sharded)
            if rank == 0:
                plain = call(vg, zeros, None)[0]
                out[f"{name}_{dtype}_delta"] = float(np.abs(sharded - plain).max())
                if name == "chains" and dtype == torch.float32:
                    blocks = call(_in_row_blocks(vg, mesh.size), zeros, None)[0]
                    out["chains_blocked"] = (float(np.abs(sharded - blocks).max()),
                                             bool(np.array_equal(sharded, blocks)))
                    solo = Mesh(CHAIN_AXIS, device=DEVICE, group=nccl_group)
                    nccl = call(vg, zeros, solo)[0]
                    out["nccl"] = (solo.backend, solo.size, bool(np.array_equal(nccl, plain)))
            out.setdefault("shapes", {})[name] = sharded.shape
    return out


def _grid_rank(rank, grid_file):
    """[grid] on one rank: the grid-sharded value-and-grad at each C of
    GRID_CHAINS, eager and replayed from a CUDA graph, with its launches
    and ms per call; then NUTS on one chain on it. ``grid_file``: the
    blocks and states, saved by the parent (a file: pickling them into the
    spawned processes took ~0.3 s per MB)."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.models import FN_SYSTEM
    from manifold_constrained_gaussian_process_inference_tpu_torch.ops import cuda_band as cb
    from manifold_constrained_gaussian_process_inference_tpu_torch.parallel import (
        make_grid_mesh, make_grid_value_and_grad, run_chains,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.parallel.chains import (
        GRAPH_WARMUP_CALLS, GraphedValueAndGrad,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.parallel.grid import (
        GridBlocks, GridShardedData,
    )

    mesh = make_grid_mesh(device=DEVICE)
    with np.load(grid_file) as f:
        data = GridShardedData(
            blocks=GridBlocks(*(f[name] for name in GridBlocks._fields)), nobs=f["nobs"],
            beta=f["beta"], **{k: int(f[k]) for k in ("n", "nloc", "bandwidth", "n_dev")},
            dtype=torch.float32)
        psi64 = torch.as_tensor(f["psi"], dtype=torch.float64, device=DEVICE)
        sigma = f["sigma"]
    vg = make_grid_value_and_grad(data, FN_SYSTEM, sigma, False, mesh)
    vg64 = make_grid_value_and_grad(data._replace(dtype=torch.float64), FN_SYSTEM, sigma, False,
                                    mesh)
    psi = psi64.float()
    out = {}
    for chains in GRID_CHAINS:
        v64, g64 = (a.cpu().numpy() for a in vg64(psi64[:chains]))
        out[chains, torch.float64] = dict(value=v64, grad=g64, digest=digest(v64, g64))
        x = psi[:chains]
        cb.reset_launches()
        v, g = vg(x)
        eager = cb.counts()
        graphed = GraphedValueAndGrad(vg, x)
        cb.reset_launches()
        vr, gr = graphed(x)
        replayed = cb.counts()
        host = [a.double().cpu().numpy() for a in (v, g, vr, gr)]
        out[chains] = dict(value=host[0], grad=host[1], digest=digest(*host),
                           replay_equal=bool(np.array_equal(host[0], host[2])
                                             and np.array_equal(host[1], host[3])),
                           eager=eager, replayed=replayed, ms=wall_ms(lambda: graphed(x)))
    counted = _Launches(cb)  # the eager tree's leaf kernels too
    counted.reset_launches()
    t0 = time.perf_counter()
    samples, info = run_chains(vg, psi[:1], torch.Generator(device=DEVICE).manual_seed(11),
                               mass_matrix="diag", **GRID_NUTS)
    out["nuts"] = dict(digest=digest(samples), finite=bool(np.isfinite(samples).all()),
                       launches=counted.counts(), wall=time.perf_counter() - t0,
                       vg_evals=GRAPH_WARMUP_CALLS + 1 + info["lockstep_leaves"],
                       leaves=info["lockstep_leaves"], doublings=info["doublings"],
                       accept=float(info["accept_prob"].mean()))
    out["blocks"] = (mesh.rank, data.nloc, tuple(vg.mphi.shape), tuple(vg.gkt.shape))
    return out


RESUME_MESH_CASES = {
    "diag NUTS": dict(n_chains=8, chain_init_jitter=0.05),
    "pooled PT": dict(sampler="pt-nuts", pt_temps=4, pt_replicas=4, mass_matrix="dense-pooled"),
    "ChEES": dict(sampler="chees", n_chains=16, chain_init_jitter=0.05),
}


def _ckpt_arrays(ckpt) -> dict:
    """A checkpoint's arrays by name (a SamplerCheckpoint or PT's dict)."""
    if isinstance(ckpt, dict):
        return {k: np.asarray(v) for k, v in ckpt.items()}
    out = {f: np.asarray(getattr(ckpt, f)) for f in ("psi", "step_size", "inv_mass", "rng_state")}
    out.update({f"st_{k}": np.asarray(v) for k, v in (ckpt.state or {}).items()})
    return out


class _KeepCheckpoint:
    """Wraps the samplers' checkpoint writer: digests every checkpoint this
    rank builds, and saves the first one ``want`` accepts to ``keep`` (on
    the rank that writes)."""

    def __init__(self, keep, want):
        from manifold_constrained_gaussian_process_inference_tpu_torch.inference import (
            chees, tempering,
        )
        from manifold_constrained_gaussian_process_inference_tpu_torch.parallel import chains

        self.modules, self.real = (chains, tempering, chees), chains.write_checkpoint
        self.keep, self.want, self.built = keep, want, []

    def __enter__(self):
        from manifold_constrained_gaussian_process_inference_tpu_torch.inference import (
            checkpoint as ck,
        )

        def write(mesh, path, ckpt, save=None):
            self.built.append(digest(*_ckpt_arrays(ckpt).values()))
            if not os.path.exists(self.keep) and self.want(ckpt) and (
                    mesh is None or mesh.rank == 0):
                (save or ck.save_checkpoint)(self.keep, ckpt)
            self.real(mesh, path, ckpt, save)

        for module in self.modules:
            module.write_checkpoint = write
        return self

    def __exit__(self, *exc):
        for module in self.modules:
            module.write_checkpoint = self.real


def _resume_mesh_rank(rank, mesh, tmp):
    """[resume-mesh] on one rank: [resume]'s runs under the mesh, killed
    and resumed; rank i also runs case i unsharded and resumes its mesh
    checkpoint in this process alone."""
    import manifold_constrained_gaussian_process_inference_tpu_torch as mt
    import torch.distributed as dist
    from manifold_constrained_gaussian_process_inference_tpu_torch.inference import (
        checkpoint as ck, tempering as tt,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.perf.workload import (
        PHI, SIGMA_TRUE, fn_bench_workload,
    )

    y, t = fn_bench_workload(n_obs=21, t_end=8.0, fill=1)
    base = dict(niter_hmc=RESUME_MESH_NITER, burnin_ratio=0.5, chunk_size=RESUME_MESH_CHUNK,
                seed=5, phi=PHI, sigma=np.full(2, SIGMA_TRUE), x_whitened=True,
                band_impl="band", device=DEVICE)
    draws = lambda res: digest(res.diagnostics["theta_per_chain"], res.x_sampled,  # noqa: E731
                               res.diagnostics["lp_per_chain"])
    out = {}
    t0 = time.perf_counter()
    pooled = mt.MagiConfig(**base, checkpoint_path=f"{tmp}/pooled.npz", n_chains=8,
                           chain_init_jitter=0.05, mass_matrix="dense-pooled", step_jitter=0.125)
    kept = f"{tmp}/pooled_kept.npz"
    mid_warmup = lambda c: (not isinstance(c, dict) and c.phase == "warmup"  # noqa: E731
                            and 0 < c.warmup["pos"] < RESUME_MESH_NITER // 2)
    with _KeepCheckpoint(kept, mid_warmup) as rec:
        full = mt.solve_magi(y, t, mt.FN_SYSTEM, pooled, mesh=mesh)
    dist.barrier()
    resumed = mt.solve_magi(y, t, mt.FN_SYSTEM, dataclasses.replace(
        pooled, checkpoint_path=f"{tmp}/pooled_r.npz"), mesh=mesh, resume=kept)
    out["pooled"] = dict(full=draws(full), resumed=draws(resumed), built=digest(*rec.built),
                         n_built=len(rec.built), pos=ck.load_checkpoint(kept).warmup["pos"],
                         key=digest(full.diagnostics["final_key"]), n_chains=8)
    sampling = lambda c: isinstance(c, dict) or c.phase == "sampling"  # noqa: E731
    more = RESUME_MESH_NITER // 2 - RESUME_MESH_CHUNK
    rmesh = tt.make_replica_mesh(device=DEVICE)
    for i, (case, extra) in enumerate(RESUME_MESH_CASES.items()):
        pt = extra.get("sampler") == "pt-nuts"
        load = tt.load_pt_checkpoint if pt else ck.load_checkpoint
        config = mt.MagiConfig(**base, **extra, checkpoint_path=f"{tmp}/{i}.npz")
        kept = f"{tmp}/{i}_kept.npz"
        with _KeepCheckpoint(kept, sampling) as rec:
            sharded = mt.solve_magi(y, t, mt.FN_SYSTEM, config, mesh=rmesh if pt else mesh)
        dist.barrier()
        leg = dataclasses.replace(config, niter_hmc=more, checkpoint_path=f"{tmp}/{i}_r.npz")
        every = mt.solve_magi(y, t, mt.FN_SYSTEM, leg, mesh=rmesh if pt else mesh, resume=kept)
        res = dict(built=digest(*rec.built), n_built=len(rec.built), resumed=draws(every),
                   key=digest(sharded.diagnostics["final_key"]),
                   n_chains=every.diagnostics["n_chains"], draws=more)
        if rank == i % mesh.size:
            plain_kept = f"{tmp}/{i}_plain_kept.npz"
            with _KeepCheckpoint(plain_kept, sampling):
                mt.solve_magi(y, t, mt.FN_SYSTEM, dataclasses.replace(
                    config, checkpoint_path=f"{tmp}/{i}_plain.npz"))
            alone = mt.solve_magi(y, t, mt.FN_SYSTEM, dataclasses.replace(
                leg, checkpoint_path=f"{tmp}/{i}_alone.npz"), resume=kept)
            a, b = _ckpt_arrays(load(kept)), _ckpt_arrays(load(plain_kept))
            res.update(alone=draws(alone), same_fields=sorted(a) == sorted(b),
                       rng_equal=bool(np.array_equal(a["rng_state"], b["rng_state"])),
                       max_delta=max(float(np.abs(a[k].astype(np.float64)
                                                  - b[k].astype(np.float64)).max())
                                     for k in a if a[k].dtype.kind == "f"))
        out[case] = res
    dist.barrier()
    out["tmp_files"] = [f for f in os.listdir(tmp) if f.endswith(".tmp")]
    out["seconds"] = time.perf_counter() - t0
    return out


def _mesh_rank(rank, y, t, grid_file, t_spawn):
    """One rank of [mesh] and [grid] (gloo, all ranks on the one card);
    ``t_spawn``: the parent's clock at the spawn."""
    import torch.distributed as dist

    t_entry = time.time()
    # every rank has started (imports, CUDA) before rank 0's host setup runs
    torch.zeros(1, device=DEVICE)
    dist.barrier()
    from manifold_constrained_gaussian_process_inference_tpu_torch.parallel import (
        make_chain_mesh,
    )

    if rank == 0:  # rank 0's host setup (NLML, Hessian) while the others wait
        torch.set_num_threads(os.cpu_count() or 1)
    mesh = make_chain_mesh(device=DEVICE)
    t0 = time.perf_counter()
    (target, whitener), solve_out = _mesh_solve(rank, mesh, y, t)
    t1 = time.perf_counter()
    from manifold_constrained_gaussian_process_inference_tpu_torch.inference.whiten import (
        make_centered_whitened_vg,
    )

    vgs = {torch.float32: make_centered_whitened_vg(target, whitener),
           torch.float64: _float64_twin(target, whitener)}
    # every rank makes the one-rank NCCL subgroup (only rank 0 is in it),
    # after (a): NCCL's threads would share the host with rank 0's setup
    nccl_group = dist.new_group([0], backend=MESH_SOLO_BACKEND)
    dry = _mesh_dryrun(rank, mesh, vgs, solve_out["dim"], nccl_group)
    t2 = time.perf_counter()
    grid_out = _grid_rank(rank, grid_file)
    t3 = time.perf_counter()
    resume_out = _resume_mesh_rank(rank, mesh, os.path.dirname(grid_file))
    return dict(solve=solve_out, dryrun=dry, grid=grid_out, resume=resume_out,
                seconds=dict(start=t_entry - t_spawn, solve=t1 - t0, dryrun=t2 - t1,
                             grid=t3 - t2, resume=time.perf_counter() - t3), t_end=time.time())


def phase_mesh(y, t, grid):
    """[mesh] and [grid]: MESH_RANKS ranks spawned over gloo on the one
    card, the kernels built before the spawn. Each line prints before its
    checks run."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.parallel.dryrun import (
        run_ranks,
    )

    import tempfile

    t0 = time.perf_counter()
    data = grid["data"]
    with tempfile.TemporaryDirectory() as tmp:
        grid_file = os.path.join(tmp, "grid.npz")
        np.savez(grid_file, **data.blocks._asdict(), nobs=data.nobs, beta=data.beta, n=data.n,
                 nloc=data.nloc, bandwidth=data.bandwidth, n_dev=data.n_dev, psi=grid["psi"],
                 sigma=grid["sigma"])
        ranks = run_ranks(_mesh_rank, MESH_RANKS, args=(y, t, grid_file, time.time()),
                          threads=max(1, (os.cpu_count() or MESH_RANKS) // MESH_RANKS))
    wall = time.perf_counter() - t0
    for r in ranks:
        r["seconds"]["stop"] = time.time() - r["t_end"]
    reports = {"mesh": _report_mesh(ranks, wall), "grid": _report_grid(ranks, grid)}
    _report_resume_mesh(ranks)
    return reports


def _report_resume_mesh(ranks):
    res = [r["resume"] for r in ranks]
    parts = []
    p = res[0]["pooled"]
    parts.append(f"pooled NUTS ({p['n_chains']} chains) killed at warmup iteration {p['pos']} "
                 f"of {RESUME_MESH_NITER // 2}, resumed under the mesh: theta, x, lp bit-equal to the "
                 f"uninterrupted sharded run on every rank "
                 f"{all(r['pooled']['full'] == r['pooled']['resumed'] for r in res)}")
    for i, case in enumerate(RESUME_MESH_CASES):
        own = res[i % len(res)][case]
        parts.append(
            f"{case} ({own['n_chains']} chains): {own['n_built']} checkpoints, the same on "
            f"every rank {len({r[case]['built'] for r in res}) == 1}; resumed unsharded on "
            f"every rank ({own['draws']} draws) to one result "
            f"{len({r[case]['resumed'] for r in res}) == 1}, bit-equal to a single-process "
            f"resume {own['resumed'] == own['alone']}; vs the unsharded run's checkpoint: same "
            f"fields {own['same_fields']}, generator state equal {own['rng_equal']}, max "
            f"|delta| {own['max_delta']:.3e}")
    print(f"[resume-mesh] {MESH_RANKS} gloo ranks on one card, [resume]'s whitened FN n=41 at "
          f"{RESUME_MESH_NITER} iterations, float32, band kernels, rank 0 writing: " + "; ".join(parts)
          + f"; generator states equal on every rank "
          f"{all(len({r[c]['key'] for r in res}) == 1 for c in ('pooled', *RESUME_MESH_CASES))}"
          f"; seconds per rank {[round(r['seconds'], 1) for r in res]}", flush=True)
    for r in res:
        check(r["pooled"]["full"] == r["pooled"]["resumed"],
              "resume-mesh: the resumed pooled warmup differs from the uninterrupted run")
        check(not r["tmp_files"], f"resume-mesh: partial files {r['tmp_files']}")
    for case in ("pooled", *RESUME_MESH_CASES):
        for what in ("built", "key"):
            check(len({r[case][what] for r in res}) == 1,
                  f"resume-mesh {case}: the ranks' {what} differ")
    for i, case in enumerate(RESUME_MESH_CASES):
        own = res[i % len(res)][case]
        check(len({r[case]["resumed"] for r in res}) == 1,
              f"resume-mesh {case}: the ranks' resumed results differ")
        check(own["resumed"] == own["alone"],
              f"resume-mesh {case}: the mesh resume differs from a single-process resume")
        check(own["same_fields"], f"resume-mesh {case}: fields differ from the unsharded run's")


def _ratios(launches, vg_evals):
    return {name: k / vg_evals for name, k in launches.items()}


def _report_mesh(ranks, wall):
    sol = [r["solve"] for r in ranks]
    a, dry = sol[0], ranks[0]["dryrun"]
    leaf_ms = [r["leaf_ms"] for r in sol]
    tp = a["phase_times"]
    print(f"[mesh] {MESH_RANKS} gloo ranks on one card, {N_CHAINS} chains "
          f"({N_CHAINS // MESH_RANKS} per rank), [slice]'s recipe cut to niter_hmc={MESH_NITER}, dim={a['dim']}: wall "
          f"{wall:.1f} s (rank 0: solve_magi {a['wall']:.1f} s, nlml {tp['nlml_s']:.2f}, gn_map "
          f"{tp['gn_map_s']:.2f}, whitener {tp['whitener_s']:.2f}, warmup {tp['warmup_s']:.2f}, "
          f"sampling {tp['sampling_s']:.2f} s); ms per batched leaf per rank "
          f"{np.round(leaf_ms, 4).tolist()}; per rank "
          f"{[_host_reads(r['reads'], f'mesh rank {i}') for i, r in enumerate(sol)]}; "
          f"batched leaves per transition per rank "
          f"{[round(r['leaves'] / r['transitions'], 1) for r in sol]} vs mean per chain "
          f"{[round(r['chain_leaves'] / r['transitions'], 1) for r in sol]}; max R-hat "
          f"{a['rhat']:.4f}; theta RMSE {a['theta_rmse']:.4f}, sigma RMSE {a['sigma_rmse']:.4f}, "
          f"divergent {a['divergent']:.4f}; launches per value-and-grad per rank "
          f"{[_ratios(r['launches'], r['vg_evals']) for r in sol]} on routes "
          f"{[r['vg_route'] for r in sol]} "
          f"({[r['vg_evals'] for r in sol]} value-and-grads); target, whitener and their "
          f"value-and-grad identical on every rank: {len({r['sampled_on'] for r in sol}) == 1}; "
          f"step sizes, metric and gathered result identical on every rank: "
          f"{len({(r['result'], r['adapted']) for r in sol}) == 1}"
          f"; dry-run protocol (3 iterations, 1 warmup, step 0.01, depth 4) sharded vs "
          f"unsharded max |delta| in float64 (float32): "
          + ", ".join(f"{name} {dry[f'{name}_{torch.float64}_delta']:.3e} "
                      f"({dry[f'{name}_{torch.float32}_delta']:.3e})" for name in DRYRUN_CALLS)
          + f" ({N_CHAINS} chains, {MESH_RANKS} replicas x 3 rungs, {CHEES_CHAINS} chains); "
          f"float32 chains vs unsharded with the value-and-grad in {MESH_RANKS} row blocks: "
          f"max |delta| {dry['chains_blocked'][0]:.3e}, bit-equal {dry['chains_blocked'][1]}; "
          f"one-rank world "
          f"{dry['nccl'][:2]} run_chains bit-equal to unsharded: {dry['nccl'][2]}; rank 0 "
          f"seconds {({k: round(v, 1) for k, v in ranks[0]['seconds'].items()})}", flush=True)
    for name in ("sampled_on", "result", "adapted"):
        check(len({r[name] for r in sol}) == 1, f"mesh: the ranks' {name} differ")
    check(a["finite"], "mesh: non-finite draws")
    per_vg = [_per_vg(r["launches"], r["vg_evals"], f"mesh rank {i}", N_CHAINS // MESH_RANKS,
                      _route(r, f"mesh rank {i}", "kernel")) for i, r in enumerate(sol)]
    for i, r in enumerate(sol):
        _leaf_launches(r["launches"], r["leaves"], r["reads"]["doublings"], f"mesh rank {i}",
                       r["transitions"], (N_CHAINS // MESH_RANKS, SLICE_DIM))
    check(a["theta_rmse"] <= THETA_RMSE_MAX, f"mesh: theta RMSE {a['theta_rmse']:.4f}")
    check(a["sigma_rmse"] <= SIGMA_RMSE_MAX, f"mesh: sigma RMSE {a['sigma_rmse']:.4f}")
    check(a["divergent"] <= MESH_MAX_DIVERGENT_SHARE, f"mesh: divergent {a['divergent']:.4f}")
    check(a["bandsize"] == MAIN_BANDSIZE, f"mesh: bandsize {a['bandsize']}")
    for name in DRYRUN_CALLS:
        for dtype in (torch.float32, torch.float64):
            check(len({r["dryrun"][f"{name}_{dtype}_digest"] for r in ranks}) == 1,
                  f"mesh: the ranks' sharded {name} draws differ ({dtype})")
        delta = dry[f"{name}_{torch.float64}_delta"]
        check(delta < DRYRUN_TOL, f"mesh: sharded {name} vs unsharded in float64 {delta:.3e}")
    check(dry["chains_blocked"][1],
          f"mesh: float32 sharded chains vs unsharded in row blocks {dry['chains_blocked'][0]:.3e}")
    check(dry["nccl"] == (MESH_SOLO_BACKEND, 1, True),
          f"mesh: one-rank NCCL run_chains vs unsharded {dry['nccl']}")
    launches = {name: sum(r["launches"][name] for r in sol) for name in sol[0]["launches"]}
    return launches, per_vg[0], float(np.mean(leaf_ms))


def _report_grid(ranks, grid):
    g0 = ranks[0]["grid"]
    parts, errs = [], {}
    for chains in GRID_CHAINS:
        for dtype in (torch.float32, torch.float64):
            cur = g0[chains] if dtype == torch.float32 else g0[chains, dtype]
            v_ref, g_ref = grid["ref"][chains, dtype]
            # the JAX dry run's measures: value relative, gradient relative
            # elementwise over |g| + 1e-3; and the gradient's error of max |g|
            errs[chains, dtype] = (
                float(np.max(np.abs(cur["value"] - v_ref) / np.maximum(1.0, np.abs(v_ref)))),
                float(np.max(np.abs(cur["grad"] - g_ref) / (1e-3 + np.abs(g_ref)))),
                float(np.abs(cur["grad"] - g_ref).max() / np.abs(g_ref).max()),
            )
        cur, e32, e64 = g0[chains], errs[chains, torch.float32], errs[chains, torch.float64]
        parts.append(f"C={chains}: vs unsharded, float64 value rel {e64[0]:.3e}, grad rel "
                     f"elementwise {e64[1]:.3e}; float32 value rel {e32[0]:.3e}, grad of max |g| "
                     f"{e32[2]:.3e} (elementwise {e32[1]:.3e}); float32 ms per value-and-grad "
                     f"sharded (replay + psum, host clock) "
                     f"{[round(r['grid'][chains]['ms'], 4) for r in ranks]} vs unsharded "
                     f"(replay) {grid['ms'][chains]:.4f}; launches per value-and-grad eager "
                     f"{cur['eager']}, replayed {cur['replayed']}")
    v64, g64 = grid["ref64_cpu"]
    e_val = float(abs(g0[1]["value"][0] - v64[0]) / abs(v64[0]))
    e_grad = float(np.abs(g0[1]["grad"][0] - g64[0]).max() / np.abs(g64[0]).max())
    nuts = [r["grid"]["nuts"] for r in ranks]
    blocks = g0["blocks"]
    print(f"[grid] n={grid['data'].n} band {grid['data'].bandwidth} over {MESH_RANKS} gloo ranks "
          f"on one card (nloc {blocks[1]}, local mphi storage {blocks[2]}, GK^T {blocks[3]}), "
          f"sigma sampled: " + "; ".join(parts) + f"; float32 chain 0 vs float64 CPU value rel "
          f"{e_val:.3e}, grad {e_grad:.3e} of max |grad|; NUTS on one chain "
          f"({GRID_NUTS['n_samples']} iterations, depth <= {GRID_NUTS['max_depth']}): "
          f"{nuts[0]['leaves']} leaves in {nuts[0]['wall']:.2f} s, accept "
          f"{nuts[0]['accept']:.3f}, launches per value-and-grad "
          f"{_ratios(nuts[0]['launches'], nuts[0]['vg_evals'])}", flush=True)
    for chains in GRID_CHAINS:
        for key in (chains, (chains, torch.float64)):
            check(len({r["grid"][key]["digest"] for r in ranks}) == 1,
                  f"grid: the ranks' value-and-grad differ at {key}")
        e32, e64 = errs[chains, torch.float32], errs[chains, torch.float64]
        # float64 under the JAX dry run's bars; float32 value alike, and its
        # gradient of max |g| (elementwise, float32 rounding of the largest
        # terms swamps the smallest components)
        check(max(e64[:2]) < GRID_TOL, f"grid C={chains} float64 vs unsharded {e64}")
        check(e32[0] < GRID_TOL and e32[2] < GRID_TOL,
              f"grid C={chains} float32 vs unsharded {e32}")
        check(g0[chains]["replay_equal"], f"grid C={chains}: replayed differs from eager")
        for r in ranks:
            for how in ("eager", "replayed"):
                _per_vg(r["grid"][chains][how], 1, f"grid C={chains} {how}", chains, "raw")
    check(e_val <= TOL_VALUE and e_grad <= TOL_GRAD,
          f"grid vs float64 CPU: value rel {e_val:.3e}, grad {e_grad:.3e}")
    check(all(n["finite"] for n in nuts), "grid NUTS: non-finite draws")
    check(len({n["digest"] for n in nuts}) == 1, "grid NUTS: the ranks' draws differ")
    nuts_per_vg = [_per_vg(n["launches"], n["vg_evals"], "grid NUTS", 1, "raw") for n in nuts]
    for i, n in enumerate(nuts):
        _leaf_launches(n["launches"], n["leaves"], n["doublings"], f"grid NUTS rank {i}")
    launches = {name: sum(n["launches"][name] for n in nuts) for name in nuts[0]["launches"]}
    return launches, nuts_per_vg[0], None


def phase_envelope(mt, cb, y, t):
    """[slice]'s recipe through solve_magi(divergence_envelope=True)."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.parallel.chains import (
        GRAPH_WARMUP_CALLS,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.perf.workload import (
        SIGMA_TRUE, THETA_TRUE,
    )

    burnin = (ENVELOPE_ADAPTS + 0.5) / ENVELOPE_NITER
    check(int(np.floor(ENVELOPE_NITER * burnin)) == ENVELOPE_ADAPTS, "envelope: warmup length")
    config = mt.MagiConfig(**{**slice_config(ENVELOPE_NITER), "burnin_ratio": burnin,
                              "step_jitter": 0.0, "chunk_size": ENVELOPE_CHUNK},
                           divergence_envelope=True, verbose=True)
    cb.reset_launches()
    t0 = time.perf_counter()
    res = mt.solve_magi(y, t, mt.FN_SYSTEM, config)
    wall = time.perf_counter() - t0
    launches = cb.counts()
    d = res.diagnostics
    points, dirs = d["envelope_points"], d["envelope_boost_dirs"]
    probe_s = d["envelope_probe_seconds"]
    minv = np.asarray(d["inv_mass"], dtype=np.float64)
    eig = np.linalg.eigvalsh(0.5 * (minv + minv.T)) if np.isfinite(minv).all() else [np.nan]
    theta_rmse = rmse(res.theta.mean(0), THETA_TRUE)
    sigma_rmse = rmse(res.sigma.mean(0), SIGMA_TRUE)
    vg_evals = GRAPH_WARMUP_CALLS + 1 + d["lockstep_leaves"]
    leaf_ms, leaves_s = _leaf_times(d)
    pt = d["phase_times_s"]
    print(f"[envelope] [slice]'s recipe, divergence_envelope=True, step_jitter 0, niter_hmc="
          f"{ENVELOPE_NITER} ({ENVELOPE_ADAPTS} warmup, chunks of {ENVELOPE_CHUNK}) chains="
          f"{N_CHAINS} band_impl={d['band_impl']} dtype={d['dtype']}; wall {wall:.1f} s: nlml "
          f"{pt['nlml_s']:.2f} s, gn_map {pt['gn_map_s']:.2f} s, hessian+whitener "
          f"{pt['whitener_s']:.2f} s, warmup {pt['warmup_s']:.2f} s (probes included), sampling "
          f"{pt['sampling_s']:.2f} s; envelope probes {points}, seconds per probe "
          f"{np.round(probe_s, 2).tolist()}, boosted directions {dirs}, max precision ratio "
          f"{d['envelope_boost_max']:.1f}; folded metric eigenvalues [{min(eig):.4g}, "
          f"{max(eig):.4g}]; step size mean {float(np.mean(d['step_size'])):.5g}; "
          f"{leaf_ms:.4f} ms per batched leaf, {leaves_s:.0f} leaves/s, "
          f"{d['lockstep_leaves'] / d['transitions']:.1f} per transition; "
          f"{_host_reads(d, 'envelope')}; sampling divergences "
          f"{d['n_divergent']} of {d['diverging'].size}; max R-hat "
          f"{max_rhat(d['theta_per_chain']):.4f} (not held); theta mean "
          f"{np.round(res.theta.mean(0), 4).tolist()} RMSE {theta_rmse:.4f}; sigma RMSE "
          f"{sigma_rmse:.4f}; route {d['vg_route']}, kernel "
          f"launches {launches} in {vg_evals} value-and-grads",
          flush=True)
    for name in ("theta", "x_sampled", "sigma", "lp"):
        check(np.isfinite(getattr(res, name)).all(), f"envelope: non-finite {name}")
    check(d["band_impl"] == "band", f"envelope: band_impl {d['band_impl']}")
    check(points >= 1, "envelope: no probe collected")
    check(1 <= dirs <= ENVELOPE_MAX_BOOST_DIMS * points,
          f"envelope: {dirs} boosted directions from {points} probes")
    check(np.isfinite(minv).all() and np.array_equal(minv, minv.T) and min(eig) > 0,
          "envelope: the folded metric is not finite and SPD")
    per_vg = _per_vg(launches, vg_evals, "envelope", N_CHAINS, _route(d, "envelope", "kernel"))
    _leaf_launches(launches, d["lockstep_leaves"], d["doublings"], "envelope",
                   d["transitions"], (N_CHAINS, SLICE_DIM))
    check(theta_rmse <= THETA_RMSE_MAX, f"envelope: theta RMSE {theta_rmse:.4f}")
    check(sigma_rmse <= SIGMA_RMSE_MAX, f"envelope: sigma RMSE {sigma_rmse:.4f}")
    return launches, per_vg, leaf_ms


def phase_profile(mt, cb):
    """[default]'s run, cut to PROFILE_NITER, with profile_dir set, against
    the same run without it."""
    import tempfile

    from manifold_constrained_gaussian_process_inference_tpu_torch.parallel.chains import (
        GRAPH_WARMUP_CALLS,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.perf.workload import (
        fn_bench_workload,
    )

    y, t = fn_bench_workload(seed=DEFAULT_SEED)
    config = dataclasses.replace(default_config(mt, PROFILE_NITER), verbose=False)
    t0 = time.perf_counter()
    plain = mt.solve_magi(y, t, mt.FN_SYSTEM, config)
    plain_wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        cb.reset_launches()
        t0 = time.perf_counter()
        res = mt.solve_magi(y, t, mt.FN_SYSTEM, dataclasses.replace(config, profile_dir=tmp))
        wall = time.perf_counter() - t0
        launches = cb.counts()
        # torch.profiler's trace and the port's own spans (utils/trace.py)
        files = sorted(os.listdir(tmp))
        traces = [f for f in files if f.endswith(".pt.trace.json")]
        check(len(traces) == 1 and files == sorted(traces + ["magi_spans_rank0.json"]),
              f"profile: trace files {files}")
        size_mb = os.path.getsize(os.path.join(tmp, traces[0])) / 2**20
        with open(os.path.join(tmp, "magi_spans_rank0.json")) as f:
            spans = json.load(f)["traceEvents"]
        check(len(spans) > 0, "profile: no span in magi_spans_rank0.json")
        with open(os.path.join(tmp, traces[0])) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    # the card's idle share over the traced sampling phase: one minus the
    # kernels' summed durations over the trace's span (its events' first
    # start to last end)
    timed = [e for e in events if "ts" in e and "dur" in e]
    span = max(e["ts"] + e["dur"] for e in timed) - min(e["ts"] for e in timed)
    idle = 1.0 - sum(e["dur"] for e in kernels) / span
    # the three entry points launch instances of two templates,
    # band_matvec_kernel (the chain tile) and band_matvec_row_kernel
    k1 = {}
    for e in kernels:
        if "band_matvec_" in e.get("name", ""):
            k1[e["name"]] = k1.get(e["name"], 0) + 1
    k1_any = sum(k1.values())
    graph_launches = sum("cudaGraphLaunch" in e.get("name", "") for e in events)
    d = res.diagnostics
    vg_evals = GRAPH_WARMUP_CALLS + 1 + d["lockstep_leaves"]
    same = all(np.array_equal(getattr(res, name), getattr(plain, name))
               for name in ("theta", "x_sampled", "sigma", "lp"))
    print(f"[profile] [default]'s config at niter_hmc={PROFILE_NITER} with profile_dir: trace "
          f"{traces[0]} {size_mb:.1f} MB, {len(events)} events ({len(spans)} spans beside it), "
          f"{len(kernels)} device kernel "
          f"events, {k1_any} band kernel events over {len(k1)} template instances "
          f"{sorted(k1.values())}, {graph_launches} CUDA graph launches; device idle share "
          f"{idle:.3f} over the trace's {1e-6 * span:.2f} s; "
          f"wall {wall:.1f} s profiled vs {plain_wall:.1f} s plain; draws bit-equal to the "
          f"unprofiled run: {same}; {_host_reads(d, 'profile')}; route {d['vg_route']}, kernel "
          f"launches {launches} in "
          f"{vg_evals} value-and-grads",
          flush=True)
    check(k1_any > 0, "profile: no band kernel in the trace")
    check(same, "profile: the profiled run's draws differ from the unprofiled run's")
    _leaf_launches(launches, d["lockstep_leaves"], d["doublings"], "profile")
    return launches, _per_vg(launches, vg_evals, "profile", config.n_chains,
                             _route(d, "profile", "raw")), None


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    import manifold_constrained_gaussian_process_inference_tpu_torch as mt
    from manifold_constrained_gaussian_process_inference_tpu_torch.ops import cuda_band
    from manifold_constrained_gaussian_process_inference_tpu_torch.perf import band_timing as bt
    from manifold_constrained_gaussian_process_inference_tpu_torch.perf.workload import (
        fn_bench_workload,
    )

    t_start = time.perf_counter()
    cb = _Launches(cuda_band)
    smi = phase_device()
    phase_build(cb)
    y, t = fn_bench_workload()
    paths = {}
    phases = {
        "likelihood": lambda: phase_likelihood(y, t),
        "likelihood-3169": phase_likelihood_3169,
        "kernel": lambda: phase_kernel(cb),
        "vg": lambda: phase_vg(out["likelihood-3169"]["cov64"]),
        "graph-if": phase_graph_if,
        "leaf": phase_leaf,
        "doubling": phase_doubling,
        "tree": lambda: phase_tree(mt, y, t),
        "diag-gauss": phase_diag_gauss,
        "default": lambda: paths.__setitem__("default", phase_default(mt, cb)),
        "families": lambda: paths.__setitem__("families", phase_families(mt, cb)),
        "slice": lambda: paths.__setitem__("slice", phase_slice(mt, cb, y, t)),
        "pt": lambda: paths.__setitem__("pt", phase_pt(mt, cb)),
        "chees": lambda: paths.__setitem__("chees", phase_chees(mt, cb, y, t)),
        "resume": lambda: phase_resume(mt),
        "mesh": lambda: paths.update(phase_mesh(y, t, out["likelihood-3169"])),
        "envelope": lambda: paths.__setitem__("envelope", phase_envelope(mt, cb, y, t)),
        "profile": lambda: paths.__setitem__("profile", phase_profile(mt, cb)),
    }
    out, phase_s = {}, {}
    for name, run in phases.items():
        t0 = time.perf_counter()
        out[name] = run()
        phase_s[name] = round(time.perf_counter() - t0, 1)
    print(f"[time] phase wall seconds {phase_s}; total {time.perf_counter() - t_start:.1f} s",
          flush=True)
    main_err, timing = out["kernel"]
    grid_label = lambda op: "grid_single" if op == "single" else "grid_pair"  # noqa: E731
    tiles_by_path = {path: {tile: p[0][tile] for tile in cb.TILES} for path, p in paths.items()}
    _, while_timing = out["graph-if"]
    leaf_err, leaf_timing = out["leaf"]
    doubling_err, doubling_timing = out["doubling"]
    leaf_err, leaf_timing = {**leaf_err, **doubling_err}, {**leaf_timing, **doubling_timing}
    for path in ("default", "families", "slice", "pt", "envelope", "profile", "mesh", "grid"):
        check(all(paths[path][0][name] > 0 for name in LEAF_KERNELS),
              f"{path}: a leaf kernel was not launched")
    for path in ("slice", "chees", "envelope", "mesh"):
        check(paths[path][0][PRODUCT_KERNEL] > 0 and paths[path][0][PREPARE_KERNEL] > 0,
              f"{path}: the product kernel or its preparation was not launched")
    vg_rows = out["vg"]
    for path in ("slice", "chees", "envelope", "mesh"):
        check(paths[path][0][VG_KERNEL] > 0 and all(paths[path][0][name] == 0 for name in KERNELS),
              f"{path}: the whitened FN kernel was not launched, or K1 was")
    for path in ("slice", "chees", "envelope"):
        check(paths[path][0].get(VG_PREPARE_KERNEL, 0) > 0,
              f"{path}: the whitened FN kernel's tiles were not prepared on the card")
    print(json.dumps({"launches_per_vg": sum(paths["slice"][1][name]
                                             for name in LIKELIHOOD_KERNELS),
                      "tile_launches_by_path": tiles_by_path, "kernels": [{
        "name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": sum(p[0][name] for p in paths.values()),
        "tile_launches": {tile: sum(p[tile] for p in tiles_by_path.values()) for tile in cb.TILES},
        "launches_by_path": {path: p[0][name] for path, p in paths.items()},
        "launches_per_vg": {path: p[1][name] for path, p in paths.items()},
        "max_abs_err": main_err[name], **timing[("main", op)],
        "long": timing[("long", op)], "c1": timing[("main_c1", op)],
        "long_c1": timing[("long_c1", op)], "pt": timing[("pt", op)],
        "chees": timing[("chees", op)], "mesh": timing[("mesh", op)],
        "grid": {"shape": bt.SHAPES[grid_label(op)], **timing[(grid_label(op), op)]},
        "grid_c1": timing[(grid_label(op) + "_c1", op)],
    } for name, op in KERNELS.items()] + [{
        "name": name, "route": "cuda", "source": LEAF_SOURCE,
        "replaces": DOUBLING_REPLACES.get(key, LEAF_REPLACES),
        "launches": sum(p[0][name] for p in paths.values()),
        "launches_by_path": {path: p[0][name] for path, p in paths.items()},
        "max_abs_err": leaf_err[key], **leaf_timing[key],
        **({"while_condition": dict(while_timing, source=WHILE_SOURCE,
                                    replaces=WHILE_REPLACES)} if key == "commit" else {}),
        **({"replaced": dict(L1_REPLACED, note="L1's drift of leaf 0 is D1's; its kernel is "
                             "gone")} if key == "open" else {}),
    } for name, key in LEAF_KERNELS.items()] + [{
        "name": PRODUCT_KERNEL, "route": "cuda", "source": PRODUCT_SOURCE,
        "replaces": PRODUCT_REPLACES,
        "launches": sum(p[0][PRODUCT_KERNEL] for p in paths.values()),
        "launches_by_path": {path: p[0][PRODUCT_KERNEL] for path, p in paths.items()},
        "max_abs_err": leaf_err["product"], **leaf_timing["product"],
    }] + [{
        "name": PREPARE_KERNEL, "route": "cuda", "source": PRODUCT_SOURCE,
        "replaces": PRODUCT_REPLACES,
        "launches": sum(p[0][PREPARE_KERNEL] for p in paths.values()),
        "launches_by_path": {path: p[0][PREPARE_KERNEL] for path, p in paths.items()},
        "max_abs_err": leaf_err["prepare"], **leaf_timing["prepare"],
    }] + [{
        "name": VG_PREPARE_KERNEL, "route": "cuda", "source": VG_SOURCE,
        "replaces": "nothing: the kernel's operand layout, made once per target",
        "launches": sum(p[0].get(VG_PREPARE_KERNEL, 0) for p in paths.values()),
        "launches_by_path": {path: p[0].get(VG_PREPARE_KERNEL, 0) for path, p in paths.items()},
        "bit_equal_to_plain": all(r["check"]["prepare_equal"] for r in vg_rows.values()),
        **{k: vg_rows["slice"]["float32"][k] for k in ("prepare_ms", "prepare_bound_ms",
                                                      "prepare_plain_ms")},
    }] + [{
        "name": VG_KERNEL, "route": "cuda", "source": VG_SOURCE, "replaces": VG_REPLACES,
        "launches": sum(p[0][VG_KERNEL] for p in paths.values()),
        "launches_by_path": {path: p[0][VG_KERNEL] for path, p in paths.items()},
        "launches_per_vg": {path: p[1][VG_KERNEL] for path, p in paths.items()},
        # float32 against the float32 plain version, beside the largest
        # |value| of the plain version, and the relative errors of both
        # dtypes against float64
        "max_abs_err": vg_rows["slice"]["check"]["max_abs_err_float32"],
        "max_abs_plain": vg_rows["slice"]["check"]["max_abs_plain_float32"],
        "rel_err": {k: v for k, v in vg_rows["slice"]["check"].items()
                    if k.startswith(("lp_", "g_"))},
        **vg_rows["slice"]["float32"],
        "float64": vg_rows["slice"]["float64"],
        "shapes": {name: {"check": r["check"], "float32": r["float32"], "float64": r["float64"]}
                   for name, r in vg_rows.items() if name != "slice"},
    }], "ms_per_leaf": {
        path: paths[path][2] for path in ("default", "slice", "pt", "mesh", "envelope")},
        "ms_per_chees_leapfrog_step": paths["chees"][2]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"[FAIL] {e}", file=sys.stderr, flush=True)
        sys.exit(1)
