"""The whitened, mode-centered FitzHugh-Nagumo value-and-grad between its
two whitening GEMMs: one hand-written CUDA kernel (csrc/centered_vg.cu: a
thread-block cluster per group of chains, its blocks splitting the grid's
rows, the banded products on the FP64 tensor cores), its tiling, its
prepared band tiles, its plain version and the dispatch between them.

Counterpart of the JAX package's ``log_posterior_centered``
(ops/likelihood.py:386) under ``jax.value_and_grad`` as its
``make_centered_whitened_vg`` (inference/whiten.py:527) builds it: a body
that XLA fuses, which the port's autograd route runs as ~140 small kernels
with K1's four band launches among them. Here, per chain, from its row of
dpsi = zeta W^T (C, dim), laid out [vec(dx) column-major; theta; log_sigma],
the forward pass

    x = x_ref + dx, theta = constrain(z), sigma = exp(clamp(log_sigma, +-15))
    e = FN(x, theta) - c_e - mphi dx,   h = GK^T e
    g = c_gc + GC^T dx,                 r = mask (dx + r_ref)
    lp = -1/2 [ sum_d (sum_i r^2 / sigma_d^2 + nobs_d log(2 pi sigma_d^2)) / beta_obs
               + |h|^2 / beta_deriv + |g|^2 / beta_level ] + log-Jacobian

(``ops/likelihood.log_posterior_centered`` with ``_combine``, and
``inference/target.MagiTarget.constrained_theta_sigma``) and its analytic
backward

    ebar = -GK h / beta_deriv
    d lp / d dx    = J_x(f)^T ebar - mphi^T ebar - GC g / beta_level
                     - r / (sigma_d^2 beta_obs)
    d lp / d theta = sum_i J_theta(f)^T ebar, times d theta / d z, plus the
                     log-Jacobian's gradient
    d lp / d log sigma_d = (sum_i r^2 / sigma_d^2 - nobs_d) / beta_obs + 1,
                     0 where the clamp holds log sigma_d (as torch.clamp's
                     gradient)

give (lp (C,), g_psi (C, dim)); g_zeta = g_psi W is the caller's GEMM. The
banded operators are the likelihood data's storages (ops/band.py layout):
mphi, GC^T, GK^T, GK, mphi^T and GC.

The route takes a target that is banded, whose system is FN
(``models/systems.fn_f``), whose theta transform is the identity or bounds
every parameter below (``uniform_kind`` 1), in float32 or float64, whose
grid is at most MAX_TERMS terms an operator (beyond it the autograd route
was the faster) and whose chain state fits one block's shared memory
(``takes``; a stated rule, not a failure path). On a CUDA tensor the dispatch launches the kernel or
raises; on a CPU tensor it runs the plain version, ``centered_fn_vg_torch``,
the same analytic forward and backward in torch operations with the banded
products of ``ops/band.py`` and no autograd. The plain version computes in
its tensors' dtype; the kernel computes in float64 whatever it stores
(float32 or float64), so in float32 it is the more accurate of the two.

The kernel reads the operators through a copy prepared once per target
(``prepare_tiles``: 16-row tiles over each row tile's window of columns,
in the storages' type, in the order of the DMMA's A fragments; plain
version ``prepare_tiles_torch``) and is launched on the tiling of
``tiling``: S blocks a cluster, each a slab of whole row tiles, Cg chains
a cluster in N tiles of 8. On the card the wrapper asks
``cudaOccupancyMaxActiveClusters`` once per tiling whether the clusters can
run at all and raises if not. The kernel is built at first use through
``ops/cuda_band.build`` into ``<package>/build/`` and bound with ctypes. Its launches are counted in
``cuda_band.KERNEL_LAUNCHES[NAME]``, beside the band kernels', so that the
CUDA graphs that capture a value-and-grad move them to their replays as
they move K1's.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..models.systems import fn_f
from . import cuda_band
from .band import band_storage_matvec_torch
from .likelihood import LOG_2PI, BandedLikelihoodData, make_centered_terms

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "centered_vg.cu"
NAME = cuda_band.CENTERED_VG
LOG_SIGMA_CLAMP = 15.0  # inference/target.LOG_SIGMA_CLAMP
N_DIMS, N_THETA = 2, 3  # FN: states (V, R), parameters (a, b, c)
# the storages' order in ``CenteredFN.bands``
BANDS = ("mphi", "GCt", "GKt", "GK", "mphi_t", "GC")
# the (n, D) constants' order in ``CenteredFN.fields``, each held (D, n)
FIELDS = ("x_ref", "r_ref", "c_e", "c_gc", "mask")
# ``CenteredFN.scalars``: beta (deriv, level, obs), nobs (D), the fixed
# sigma (D), theta's lower bounds (k), then the whitener's center past the
# x block (theta's z, then log sigma when it is sampled)
BETA, NOBS, SIGMA, LB, TAIL = 0, 3, 5, 7, 10
N_SCALARS = TAIL + N_THETA + N_DIMS
# The kernel's tiling (``tiling``; csrc/centered_vg.cu mirrors it): a
# thread-block cluster of S blocks serves Cg chains, block ``rank`` owning
# the grid rows [rank L, min(n, (rank + 1) L)) of both states, L a whole
# number of TILE_ROWS-row tiles (a DMMA's m). A tile's window of columns
# runs from its first row less b in STEP-wide k steps (a DMMA's k;
# ``ksteps``); a cluster's chains are N tiles of CHAIN_TILE (a DMMA's n), at
# most MAX_NTILES, or one N tile padded with chains that are not there
# below CHAIN_TILE. A chain's sums (N_SUMS; sum_i r^2 per state, |g|^2,
# |h|^2, the three theta gradients, one spare) go through PART_LANES
# partial lanes of L / 2 entries, and rank 0 gathers every block's; its
# parameters take N_PARAMS slots; its VECTORS staged vectors (X then H, E,
# GS) are float64 in both dtypes. S is 1 where one block has a warp for
# every (tile, state) item (2 tiles <= MAX_WARPS: more blocks would only add
# cluster barriers and halo exchanges to the same warps' work), else the
# least number of slabs of whole tiles, at most WAVE_CLUSTER: at one block
# an SM the H100 runs only 15 clusters of 7 or 8 at once
# (cudaOccupancyMaxActiveClusters; 7 of 13), so the 16th of C = 128 in
# chain groups of 8 waits for a whole launch's time. WAVE_CLUSTER is also
# the kernel's largest cluster (its rank 0 gathers that many blocks' sums).
# Cg is 1 where a block a chain keeps the launch within TARGET_BLOCKS
# blocks (the H100 SXM's 132 SMs, one block each): a block's time grows with
# its chains (the fill, the epilogues, the sums) and its DMMAs' do not, so
# at [resume]'s C = 8 one chain a block ran 0.0147 ms and eight 0.0164
# (perf/vg_timing.py --variants k1, PERF.md). Elsewhere Cg is the least
# multiple of CHAIN_TILE that keeps the launch within TARGET_BLOCKS, as
# shared memory allows. A block has a warp per
# (tile, state) item of a stage, at most MAX_WARPS; each warp streams its
# prepared tiles (k steps of FRAG_ELEMS values) through a ring of
# MIN_SLOTS to RING_SLOTS slots of SLOT_BYTES, each under an mbarrier of 8
# bytes, the block's rings at most RING_BYTES and leaving the chains their
# room. MAX_SHARED_BYTES is a block's opt-in maximum.
TILE_ROWS, STEP, CHAIN_TILE, MAX_NTILES = 16, 8, 8, 4
MAX_WARPS, WAVE_CLUSTER, TARGET_BLOCKS = 12, 5, 132
RING_SLOTS, MIN_SLOTS, RING_BYTES, SLOT_BYTES, FRAG_ELEMS = 6, 2, 98304, 2048, 128
N_SUMS, N_PARAMS, PART_LANES, VECTORS = 8, 12, 4, 3
MAX_SHARED_BYTES = 232448

# The longest grid the route takes, as n (2b+1), one operator's terms. On
# the H100, ms per replayed value-and-grad, kernel route against autograd
# route (perf/vg_timing.py, PERF.md): config 4's grid (n = 793, b = 80)
# 0.112-0.117 against 0.392 at 128 chains, 0.071 against 0.226 at one;
# n = 3169, b = 160, 0.98-0.99 against 1.01 at 128 chains (the kernel 0.52
# ms of it), 0.50-0.51 against 0.38-0.39 at one. Past config 4's grid the
# autograd route is as fast or faster, so the route stops there.
MAX_TERMS = 793 * 161

# The two whitening GEMMs around the kernel (dpsi = zeta W^T, g_zeta =
# g_psi W) take the dense metric's product kernel (ops/minv_mv.py, on W and
# W^T prepared once) from GEMM_MIN_SIZE = C dim and up to GEMM_MAX_WORK = C
# dim^2, torch.matmul elsewhere. On the H100, ms per launch, kernel against
# torch.matmul (perf/product_timing.py, PERF.md): (128, 799) 0.0098-0.0100
# against 0.0123, (64, 799) 0.0078 / 0.0111, (32, 799) 0.0077 / 0.0090,
# (3, 799) 0.0053 / 0.0060, (64, 1591) 0.0157 / 0.0163, (128, 87) 0.0056 /
# 0.0070, (32, 87) 0.0035 / 0.0067; slower at one chain (0.0053 / 0.0030 at
# dim 799), (3, 87) 0.00252 / 0.00239 and (128, 1591) 0.0250 / 0.0232.
GEMM_MIN_SIZE, GEMM_MAX_WORK = 2048, 2 ** 28

_LIB = None

# Launches of the tiles' preparation (``prepare_tiles`` on the card, once
# per target) since the last reset; the kernel's own are
# ``cuda_band.KERNEL_LAUNCHES[NAME]``
PREPARE = "centered_vg_prepare"
LAUNCHES = {PREPARE: 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class CenteredFN(NamedTuple):
    """A whitened FN target's constants as the plain version and the
    kernel read them."""

    bands: torch.Tensor    # (6, D, 2b+1, n): the storages of BANDS
    tiles: torch.Tensor    # (6, D, row tiles, ksteps, FRAG_ELEMS): ``prepare_tiles``
    fields: torch.Tensor   # (5, D, n): FIELDS, transposed to (D, n)
    scalars: torch.Tensor  # (N_SCALARS,)
    n: int
    bandwidth: int
    sigma_sampled: bool
    theta_kind: int        # 0: theta = z; 1: theta = lb + exp(z)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def ksteps(bandwidth: int) -> int:
    """k steps of STEP columns in a row tile's window: its TILE_ROWS rows
    and b columns each side."""
    return _cdiv(TILE_ROWS + 2 * bandwidth, STEP)


def tiles_shape(n: int, bandwidth: int) -> tuple:
    """The prepared copy's shape: (operators, states, row tiles, k steps,
    FRAG_ELEMS)."""
    return len(BANDS), N_DIMS, _cdiv(n, TILE_ROWS), ksteps(bandwidth), FRAG_ELEMS


def _tile_index(n: int, bandwidth: int):
    """(i, j) of every entry of one operator's prepared copy, shaped
    (row tiles, k steps, 32, 2, 2) as [rt][ks][lane][h][e]: the DMMA's A
    fragment of rows 16 rt.. and columns 16 rt - b + 8 ks..; lane = 4 g + t
    holds rows g and g + 8 (e) of columns t and t + 4 (h), its a[2 h + e]."""
    rt = torch.arange(_cdiv(n, TILE_ROWS)).view(-1, 1, 1, 1, 1)
    ks = torch.arange(ksteps(bandwidth)).view(1, -1, 1, 1, 1)
    lane = torch.arange(32).view(1, 1, 32, 1, 1)
    h = torch.arange(2).view(1, 1, 1, 2, 1)
    e = torch.arange(2).view(1, 1, 1, 1, 2)
    i = TILE_ROWS * rt + lane // 4 + 8 * e
    j = TILE_ROWS * rt - bandwidth + STEP * ks + lane % 4 + 4 * h
    return torch.broadcast_tensors(i, j)


def prepare_tiles_torch(bands: torch.Tensor, bandwidth: int) -> torch.Tensor:
    """The kernel's copy of band storages (..., 2b+1, n) (ops/band.py layout,
    A[i, j] at [b + j - i, j]): in the storages' type, shaped (..., row
    tiles, k steps, FRAG_ELEMS), entry [rt, ks, 4 lane + 2 h + e] =
    A[16 rt + lane // 4 + 8 e, 16 rt - b + 8 ks + lane % 4 + 4 h], zero
    outside the band, outside the grid and in the last tile's rows past n.
    A row tile's window is then contiguous, k step after k step, each in
    the order of a warp's A fragments: a bulk copy stages a run of k steps
    and each lane reads its four values as one vector (16 bytes in float32,
    converted exactly to float64 as it reads them, 32 in float64)."""
    b = bandwidth
    *lead, w, n = bands.shape
    i, j = (t.to(bands.device) for t in _tile_index(n, b))
    inside = (i < n) & (j >= 0) & (j < n) & ((j - i).abs() <= b)
    flat = bands.reshape(-1, w * n)
    at = torch.where(inside, (b + j - i) * n + j, 0).reshape(-1)
    out = torch.where(inside.reshape(-1), flat[:, at], 0.0)
    return out.reshape(*lead, *i.shape[:2], FRAG_ELEMS)


def prepare_tiles(bands: torch.Tensor, bandwidth: int) -> torch.Tensor:
    """``prepare_tiles_torch``'s copy: on a CUDA tensor one launch of the
    kernel library's preparation (bit-equal: every entry is a storage's
    value or zero), on a CPU one the plain version. ``bands`` (6, D, 2b+1,
    n) as ``CenteredFN.bands``."""
    if bands.device.type != "cuda":
        return prepare_tiles_torch(bands, bandwidth)
    n = bands.shape[-1]
    if tuple(bands.shape) != (len(BANDS), N_DIMS, 2 * bandwidth + 1, n) or not bands.is_contiguous():
        raise ValueError(f"prepare_tiles: contiguous storages {(len(BANDS), N_DIMS)} + (2b+1, n); "
                         f"got {tuple(bands.shape)}")
    out = torch.empty(tiles_shape(n, bandwidth), dtype=bands.dtype, device=bands.device)
    lib = _library()
    fn = lib.centered_vg_prepare_f64 if bands.dtype == torch.float64 else lib.centered_vg_prepare_f32
    err = fn(ctypes.c_void_p(bands.data_ptr()), ctypes.c_void_p(out.data_ptr()), n, bandwidth,
             ctypes.c_void_p(torch.cuda.current_stream(bands.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{NAME}: the tiles' preparation failed: CUDA error {err}")
    LAUNCHES[PREPARE] += 1
    return out


class Tiling(NamedTuple):
    """One launch's tiling (``tiling``)."""

    cluster: int       # S: blocks a cluster, each a slab of rows
    slab: int          # L: rows a slab, whole tiles (the last slab may be shorter)
    chains: int        # Cg: chains a cluster
    ntiles: int        # N tiles of CHAIN_TILE chains a cluster (one padded one below it)
    reach: int         # the slabs each side a block's halo of b rows takes rows from
    clusters: int      # clusters of the launch, ceil(C / Cg)
    threads: int       # threads a block: a warp per item of a stage, at most MAX_WARPS
    shared_bytes: int  # dynamic shared memory a block
    slabs: tuple       # (lo, hi) of each rank's slab


def cluster_size(n: int, bandwidth: int) -> int:
    """S: 1 where one block's MAX_WARPS warps take every (tile, state)
    item of the grid at once, else the least number of slabs of whole row
    tiles, each the same number of tiles (the last may have fewer rows),
    that keeps S at most WAVE_CLUSTER. Depends on n alone (the band enters
    through the halos)."""
    tiles = _cdiv(n, TILE_ROWS)
    if 2 * tiles <= MAX_WARPS:
        return 1
    return _cdiv(tiles, _cdiv(tiles, WAVE_CLUSTER))


def _stride(width: int) -> int:
    """A staged vector's stride in doubles, at least ``width`` and 4 modulo
    16: the 8 x 4 doubles of a B fragment then fall in distinct banks."""
    return width + (4 - width) % 16


def chain_bytes(slab: int, bandwidth: int) -> int:
    """Shared memory one chain takes in a block with a slab of ``slab``
    rows: its parameters and sums, the cluster's blocks' sums (gathered
    in rank 0), PART_LANES partial lanes of slab / 2 entries, and VECTORS
    vectors of both states over every row tile's window (the slab less one
    tile plus a window's k steps), all float64."""
    width = slab - TILE_ROWS + STEP * ksteps(bandwidth)
    return 8 * (N_PARAMS + N_SUMS + WAVE_CLUSTER * (N_SUMS - 1) + PART_LANES * (slab // 2)
                + VECTORS * N_DIMS * _stride(width))


def warps(slab: int) -> int:
    """A block's warps: one per (tile, state) item of a stage, at most
    MAX_WARPS."""
    return min(2 * (slab // TILE_ROWS), MAX_WARPS)


def ring_slots(slab: int, bandwidth: int, chains: int) -> int:
    """Slots of a warp's ring: RING_SLOTS, fewer where the block's rings
    would pass RING_BYTES or leave too little of MAX_SHARED_BYTES for
    ``chains`` chains."""
    w = warps(slab)
    left = MAX_SHARED_BYTES - chains * chain_bytes(slab, bandwidth)
    return min(RING_SLOTS, RING_BYTES // (w * SLOT_BYTES), left // (w * (SLOT_BYTES + 8)))


def ring_bytes(slab: int, bandwidth: int, chains: int) -> int:
    """Shared memory of a block's rings: its warps' slots and their
    mbarriers."""
    return warps(slab) * ring_slots(slab, bandwidth, chains) * (SLOT_BYTES + 8)


def tiling(n: int, bandwidth: int, n_chains: int) -> Tiling:
    """The launch for C = ``n_chains`` chains on a grid of n rows, band b.
    S and the slabs depend on (n, b) alone; Cg is 1 where C S blocks fit
    TARGET_BLOCKS, else the least multiple of CHAIN_TILE (at most
    MAX_NTILES of them and no more than C needs) whose clusters keep the
    launch within TARGET_BLOCKS blocks, as shared memory allows; where
    shared memory holds fewer than CHAIN_TILE, one padded N tile of as
    many as fit. Threads: ``warps``. Raises ValueError when one chain's
    state is beyond a block's shared memory beside its rings."""
    s = cluster_size(n, bandwidth)
    slab = TILE_ROWS * _cdiv(_cdiv(n, TILE_ROWS), s)
    per_chain = chain_bytes(slab, bandwidth)
    room = MAX_SHARED_BYTES - warps(slab) * MIN_SLOTS * (SLOT_BYTES + 8)
    fits = room // per_chain
    if fits < 1:
        raise ValueError(f"centered_vg: a chain at n = {n}, b = {bandwidth} needs {per_chain} "
                         f"bytes of shared memory, more than {room}")
    if n_chains * s <= TARGET_BLOCKS:
        c = 1
    elif fits < CHAIN_TILE:
        c = fits
    else:
        most = min(MAX_NTILES, fits // CHAIN_TILE, _cdiv(n_chains, CHAIN_TILE))
        m = next((m for m in range(1, most + 1)
                  if s * _cdiv(n_chains, CHAIN_TILE * m) <= TARGET_BLOCKS), most)
        c = CHAIN_TILE * m
    slabs = tuple((r * slab, min(n, (r + 1) * slab)) for r in range(s))
    return Tiling(cluster=s, slab=slab, chains=c, ntiles=max(1, c // CHAIN_TILE),
                  reach=_cdiv(bandwidth, slab) if s > 1 else 0, clusters=_cdiv(n_chains, c),
                  threads=32 * warps(slab),
                  shared_bytes=ring_bytes(slab, bandwidth, c) + c * per_chain,
                  slabs=slabs)


def gemm_takes_kernel(n_chains: int, dim: int) -> bool:
    """Whether the route's whitening GEMMs of ``n_chains`` x ``dim`` run
    on the product kernel (on the card; see GEMM_MIN_SIZE)."""
    return GEMM_MIN_SIZE <= n_chains * dim and n_chains * dim * dim <= GEMM_MAX_WORK


def takes(target) -> bool:
    """Whether ``target``'s whitened value-and-grad takes this route: a
    banded target of the FN system, theta unbounded or bounded below in
    every parameter, float32 or float64, a grid of at most MAX_TERMS terms
    an operator, and one chain's state within a block's shared memory
    (``chain_bytes`` of its tiling's slab)."""
    if not isinstance(target.data, BandedLikelihoodData) or target.system.f is not fn_f:
        return False
    if target.n_times * (2 * target.bandwidth + 1) > MAX_TERMS:
        return False
    consts = target.theta_consts
    if consts is not None and consts.uniform_kind not in (0, 1):
        return False
    dtype = target.data.mask.dtype
    if dtype not in (torch.float32, torch.float64):
        return False
    n, b = target.n_times, int(target.bandwidth)
    try:
        tiling(n, b, 1)
    except ValueError:
        return False
    return True


def make_params(target, center) -> CenteredFN:
    """The kernel's constants for ``target`` (``takes(target)``) centered
    at ``center`` (a whitener's, (dim,)): the mode-centered terms (host,
    float64, as ``ops/likelihood.make_centered_terms``), the storages
    stacked, and the scalars."""
    data = target.data
    n, d, k = target.n_times, target.n_dims, target.n_params_ode
    nd = n * d
    if isinstance(center, torch.Tensor):
        center = center.detach().to("cpu", torch.float64).numpy()
    center = np.asarray(center, dtype=np.float64)
    cent = make_centered_terms(data, center[:nd].reshape(d, n).T, target.bandwidth)
    like = data.mask
    consts = target.theta_consts
    kind = 0 if consts is None else consts.uniform_kind
    lb = np.zeros(k) if consts is None else consts.lb.detach().cpu().double().numpy()
    tail = np.zeros(k + d)
    tail[: center.shape[0] - nd] = center[nd:]
    scalars = np.concatenate([
        data.beta.detach().cpu().double().numpy(), data.nobs.detach().cpu().double().numpy(),
        target.sigma_init.detach().cpu().double().numpy(), lb, tail,
    ])
    storages = (data.mphi_bs, data.GCt_bs, data.GKt_bs, data.GK_bs, data.mphi_t_bs, data.GC_bs)
    fields = (cent.x_ref, cent.r_ref, cent.c_e, cent.c_gc, data.mask)
    bands = torch.stack(storages).contiguous()
    return CenteredFN(
        bands=bands, tiles=prepare_tiles(bands, int(target.bandwidth)),
        fields=torch.stack([f.transpose(0, 1) for f in fields]).contiguous(),
        scalars=torch.as_tensor(scalars, dtype=like.dtype, device=like.device),
        n=n, bandwidth=int(target.bandwidth), sigma_sampled=not target.sigma_is_fixed,
        theta_kind=int(kind),
    )


# -- the plain version ---------------------------------------------------------


def centered_fn_vg_torch(dpsi: torch.Tensor, p: CenteredFN):
    """(lp (C,), g_psi (C, dim)) from dpsi (C, dim): the kernel's forward
    and analytic backward in torch operations, in its order."""
    c, dim = dpsi.shape
    n, d, k, b = p.n, N_DIMS, N_THETA, p.bandwidth
    nd = n * d
    s = p.scalars
    beta_deriv, beta_level, beta_obs = s[BETA], s[BETA + 1], s[BETA + 2]
    nobs = s[NOBS : NOBS + d]
    mphi, gct, gkt, gk, mphi_t, gc = p.bands.unbind(0)
    x_ref, r_ref, c_e, c_gc, mask = p.fields.unbind(0)
    mv = lambda bands, xs: band_storage_matvec_torch(bands, xs, b)  # noqa: E731

    dx = dpsi[:, :nd].reshape(c, d, n)
    tail = s[TAIL : TAIL + dim - nd] + dpsi[:, nd:]
    z = tail[:, :k]
    jacs = []
    if p.theta_kind == 1:
        ez = torch.exp(z)
        theta = s[LB : LB + k] + ez
        jacs.append(torch.sum(z, dim=-1))
    else:
        theta = z
    if p.sigma_sampled:
        log_sigma = tail[:, k:]
        clamped = torch.clamp(log_sigma, -LOG_SIGMA_CLAMP, LOG_SIGMA_CLAMP)
        sigma = torch.exp(clamped)
        jacs.append(torch.sum(clamped, dim=-1))
    else:
        sigma = s[SIGMA : SIGMA + d].expand(c, d)
    jac = sum(jacs) if jacs else torch.zeros(c, dtype=dpsi.dtype, device=dpsi.device)
    sigma_sq = (sigma * sigma)[:, :, None]  # (C, D, 1)

    # forward
    x = x_ref + dx
    v, r = x[:, 0], x[:, 1]
    ta, tb, tc = (theta[:, m, None] for m in range(k))
    f = torch.stack([tc * (v - v**3 / 3.0 + r), -1.0 / tc * (v - ta + tb * r)], dim=1)
    e = f - c_e - mv(mphi, dx)
    h = mv(gkt, e)
    g = c_gc + mv(gct, dx)
    res = mask * (dx + r_ref)
    sse = torch.sum(res * res, dim=-1)  # (C, D)
    obs = torch.sum(sse / sigma_sq[..., 0] + nobs * (LOG_2PI + torch.log(sigma_sq[..., 0])),
                    dim=-1)
    quad = torch.sum(h * h, dim=(-2, -1)) / beta_deriv + torch.sum(g * g, dim=(-2, -1)) / beta_level
    lp = -0.5 * (obs / beta_obs + quad) + jac

    # backward
    ebar = mv(gk, -h / beta_deriv)
    e0, e1 = ebar[:, 0], ebar[:, 1]
    jx = torch.stack([e0 * (tc * (1.0 - v * v)) + e1 * (-1.0 / tc), e0 * tc + e1 * (-tb / tc)],
                     dim=1)
    g_dx = jx - mv(mphi_t, ebar) + mv(gc, -g / beta_level) - res / (sigma_sq * beta_obs)
    g_theta = torch.stack([
        torch.sum(e1 / tc, dim=-1),
        torch.sum(e1 * (-r / tc), dim=-1),
        torch.sum(e0 * (v - v**3 / 3.0 + r) + e1 * ((v - ta + tb * r) / (tc * tc)), dim=-1),
    ], dim=-1)
    parts = [g_dx.reshape(c, nd), g_theta * ez + 1.0 if p.theta_kind == 1 else g_theta]
    if p.sigma_sampled:
        inside = (log_sigma >= -LOG_SIGMA_CLAMP) & (log_sigma <= LOG_SIGMA_CLAMP)
        g_ls = (sse / sigma_sq[..., 0] - nobs) / beta_obs + 1.0
        parts.append(torch.where(inside, g_ls, 0.0))
    return lp, torch.cat(parts, dim=-1)


# -- the kernel ------------------------------------------------------------------


def load(source: Path = SOURCE):
    """Build ``source`` (the kernel's, a measurement copy of it, or a
    baseline under ``perf/baselines``), bind its C entry points and set its
    instances' shared-memory and cluster limits."""
    lib = ctypes.CDLL(str(cuda_band.build(source)))
    p = ctypes.c_void_p
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"{NAME}_{suffix}")
        fn.argtypes, fn.restype = [p, p, p], ctypes.c_int
    lib.centered_vg_init.argtypes, lib.centered_vg_init.restype = [], ctypes.c_int
    if hasattr(lib, "centered_vg_prepare_f32"):  # not in the baselines
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"centered_vg_prepare_{suffix}")
            fn.argtypes, fn.restype = [p, p, ctypes.c_int, ctypes.c_int, p], ctypes.c_int
    if hasattr(lib, "centered_vg_max_clusters"):  # not in the one-block baseline
        lib.centered_vg_max_clusters.argtypes = [p, ctypes.c_int, p]
        lib.centered_vg_max_clusters.restype = ctypes.c_int
    err = lib.centered_vg_init()
    if err != 0:
        raise RuntimeError(f"{NAME}: setting the kernels' shared memory failed: CUDA error {err}")
    return lib


def _library():
    global _LIB
    if _LIB is None:
        _LIB = load()
    return _LIB


# the kernel's pointer and integer arguments, in the order of its VgArgs
# and its Launch
POINTERS = ("dpsi", "tiles", "fields", "scalars", "g_psi", "lp")
INTS = ("n_chains", "n", "bandwidth", "dim", "sigma_sampled", "theta_kind", "cluster", "slab",
        "chains", "threads", "shared_bytes", "n_pointers", "n_ints")
# (library, tiling, float64) -> clusters the card runs at once
_MAX_CLUSTERS = {}


def centered_fn_vg_cuda(dpsi: torch.Tensor, p: CenteredFN):
    """The kernel on the current stream: (lp (C,), g_psi (C, dim)) from
    dpsi (C, dim), contiguous, on the device and in the dtype of ``p``."""
    return launch(None, dpsi, p)


def _ints(c: int, dim: int, p: CenteredFN, tile: Tiling):
    return (ctypes.c_longlong * len(INTS))(
        c, p.n, p.bandwidth, dim, int(p.sigma_sampled), p.theta_kind, tile.cluster, tile.slab,
        tile.chains, tile.threads, tile.shared_bytes, len(POINTERS), len(INTS))


def max_clusters(lib, ints, f64: bool) -> int:
    """Clusters of the launch ``ints`` describes that the card runs at once
    (cudaOccupancyMaxActiveClusters); raises on a CUDA error."""
    out = ctypes.c_int(0)
    err = lib.centered_vg_max_clusters(ints, int(f64), ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"{NAME}: cudaOccupancyMaxActiveClusters failed: CUDA error {err}")
    return out.value


def launch(lib, dpsi: torch.Tensor, p: CenteredFN):
    """``centered_fn_vg_cuda`` through the library ``lib`` (``load``;
    None: the kernel's own, built at first use). Raises on an input it
    does not take, before any build, and when the card cannot run the
    tiling's clusters."""
    c, dim = dpsi.shape
    n, d = p.n, N_DIMS
    want_dim = n * d + N_THETA + (d if p.sigma_sampled else 0)
    tensors = dict(dpsi=dpsi, fields=p.fields, scalars=p.scalars)
    for what, t in tensors.items():
        if t.device != dpsi.device or t.dtype != dpsi.dtype or not t.is_contiguous():
            raise ValueError(f"centered_fn_vg_cuda: {what} must be a contiguous {dpsi.dtype} "
                             f"tensor on {dpsi.device}; got {t.dtype} on {t.device}")
    if dpsi.device.type != "cuda" or dpsi.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"centered_fn_vg_cuda: float32 or float64 on a CUDA device; got "
                         f"{dpsi.dtype} on {dpsi.device}")
    want_tiles = tiles_shape(n, p.bandwidth)
    if (dim != want_dim or tuple(p.tiles.shape) != want_tiles or p.tiles.dtype != dpsi.dtype
            or p.tiles.device != dpsi.device or not p.tiles.is_contiguous()
            or tuple(p.fields.shape) != (len(FIELDS), d, n)
            or tuple(p.scalars.shape) != (N_SCALARS,) or p.theta_kind not in (0, 1)):
        raise ValueError(f"centered_fn_vg_cuda: dpsi {tuple(dpsi.shape)} (dim {want_dim}), "
                         f"tiles {tuple(p.tiles.shape)} {p.tiles.dtype} on {p.tiles.device} "
                         f"(want {want_tiles} {dpsi.dtype}), fields {tuple(p.fields.shape)}, "
                         f"theta kind {p.theta_kind}")
    tile = tiling(n, p.bandwidth, max(c, 1))
    lib = _library() if lib is None else lib
    g_psi = torch.empty_like(dpsi)
    lp = torch.empty(c, dtype=dpsi.dtype, device=dpsi.device)
    if c == 0:
        return lp, g_psi
    f64 = dpsi.dtype == torch.float64
    ints = _ints(c, dim, p, tile)
    key = (id(lib), tile, f64)
    if key not in _MAX_CLUSTERS:
        _MAX_CLUSTERS[key] = max_clusters(lib, ints, f64)
    if _MAX_CLUSTERS[key] < 1:
        raise RuntimeError(f"{NAME}: the card cannot run a cluster of {tile.cluster} blocks of "
                           f"{tile.threads} threads and {tile.shared_bytes} bytes of shared "
                           f"memory ({tile})")
    out = dict(tensors, tiles=p.tiles, g_psi=g_psi, lp=lp)
    ptrs = (ctypes.c_void_p * len(POINTERS))(*(out[k].data_ptr() for k in POINTERS))
    fn = getattr(lib, f"{NAME}_{'f64' if f64 else 'f32'}")
    err = fn(ptrs, ints, torch.cuda.current_stream(dpsi.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err} ({tile})")
    cuda_band.KERNEL_LAUNCHES[NAME] += 1
    return lp, g_psi


# -- the dispatch ------------------------------------------------------------------


def centered_fn_vg(dpsi: torch.Tensor, p: CenteredFN):
    """(lp, g_psi) from dpsi (C, dim): the kernel on a CUDA tensor, the
    plain version on a CPU one."""
    if dpsi.device.type == "cuda":
        return centered_fn_vg_cuda(dpsi.contiguous(), p)
    if dpsi.device.type != "cpu":
        raise ValueError(f"centered_fn_vg: unsupported device {dpsi.device}")
    return centered_fn_vg_torch(dpsi, p)


# -- the bound ---------------------------------------------------------------------


def bound_work(n_chains: int, n: int, bandwidth: int, dim: int, itemsize: int):
    """(bytes, multiply-adds) one launch must move and do: dpsi read and
    g_psi and lp written, the six storages and five (D, n) fields read once;
    six banded products of (2b+1) terms per output (rows near the ends
    count only their terms inside the grid)."""
    i = np.arange(n)
    terms = int(np.sum(np.minimum(bandwidth, n - 1 - i) + np.minimum(bandwidth, i) + 1))
    fma = 6 * n_chains * N_DIMS * terms
    moved = itemsize * (2 * n_chains * dim + n_chains + len(BANDS) * N_DIMS * (2 * bandwidth + 1)
                        * n + len(FIELDS) * N_DIMS * n + N_SCALARS)
    return moved, fma
