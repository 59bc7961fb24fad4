"""The whitened, mode-centered FitzHugh-Nagumo value-and-grad between its
two whitening GEMMs: one hand-written CUDA kernel (csrc/centered_vg.cu: a
thread-block cluster per group of chains, its blocks splitting the grid's
rows), its tiling, its plain version and the dispatch between them.

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

The kernel reads the storages through its own row-indexed copy
(``band_diags``) and is launched on the tiling of ``tiling``: S blocks a
cluster, each a slab of rows, Cg chains a cluster, G a thread. On the card
the wrapper asks ``cudaOccupancyMaxActiveClusters`` once per tiling
whether the clusters can run at all and raises if not. The kernel is built
at first use through ``ops/cuda_band.build`` into ``<package>/build/`` and
bound with ctypes. Its launches are counted in
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
# the grid rows [rank L, min(n, (rank + 1) L)) of both states; a thread's
# unit is ROWS consecutive rows of one state for G chains. A chain's
# sums (N_SUMS; sum_i r^2 per state, |g|^2, |h|^2, the three theta
# gradients, one spare) go through PART_LANES partial lanes per unit; its
# parameters take N_PARAMS slots; its VECTORS staged vectors (X then H, E,
# GS) are float64 in both dtypes. S is the largest power of two up to
# MAX_CLUSTER leaving slabs of at least max(b, MIN_SLAB) rows; Cg the chains
# that fill TARGET_BLOCKS blocks (the H100's 132 SMs, one block each), as
# shared memory allows. MAX_SHARED_BYTES is a block's opt-in maximum.
ROWS, MAX_THREADS, MAX_CLUSTER, MIN_SLAB, TARGET_BLOCKS = 2, 256, 16, 32, 128
# G at most (the kernel's instances take G = 1, 2, 4, 8), and the units a
# block should keep: on the H100 blocks of ~100 units ran fastest, fewer
# leaving too few warps, more loading and converting each coefficient again
# for each further chain subgroup (perf/vg_timing.py --variants, PERF.md)
MAX_PER_THREAD, MIN_UNITS = 8, 96
N_SUMS, N_PARAMS, PART_LANES, VECTORS = 8, 8, 4, 3
MAX_SHARED_BYTES = 232448

# The longest grid the route takes, as n (2b+1), one operator's terms. On
# the H100, ms per replayed value-and-grad, kernel route against autograd
# route (perf/vg_timing.py, PERF.md): config 4's grid (n = 793, b = 80)
# 0.170 against 0.393 at 128 chains, 0.062 against 0.223 at one; n = 3169,
# b = 160, 1.193 against 1.008 at 128 chains (the kernel 0.72 ms of it),
# 0.258 against 0.386 at one. At 128 chains the routes cross between the
# two grids, so the route stops at config 4's.
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


class CenteredFN(NamedTuple):
    """A whitened FN target's constants as the plain version and the
    kernel read them."""

    bands: torch.Tensor    # (6, D, 2b+1, n): the storages of BANDS
    band_diags: torch.Tensor  # (6, D, *diag_shape(n, b)): the same, indexed by row
    fields: torch.Tensor   # (5, D, n): FIELDS, transposed to (D, n)
    scalars: torch.Tensor  # (N_SCALARS,)
    n: int
    bandwidth: int
    sigma_sampled: bool
    theta_kind: int        # 0: theta = z; 1: theta = lb + exp(z)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def diag_shape(n: int, bandwidth: int) -> tuple:
    """(terms, columns) of one operator in the kernel's diagonal copy: the
    2b+1 terms padded with zero terms to whole chunks of 8, and the n rows
    padded with zero rows to an even count of at least n + ROWS."""
    return 8 * _cdiv(2 * bandwidth + 1, 8), 2 * _cdiv(n + ROWS, 2)


def band_diags(bands: torch.Tensor, bandwidth: int) -> torch.Tensor:
    """The kernel's copy of diagonal band storages (..., 2b+1, n) (ops/band.py
    layout, indexed by column): out[..., b + k, i] = A[i, i + k], indexed by
    row, zero where i + k lies outside [0, n) and in the padding of
    ``diag_shape``. A unit's rows of one term are then one aligned vector,
    neighbouring units' neighbouring ones, and no edge of the grid needs a
    test in the kernel."""
    b = bandwidth
    *lead, w, n = bands.shape
    flat = bands.reshape(-1, w, n)
    width = n + 2 * b
    padded = torch.nn.functional.pad(flat, (b, b)).contiguous()
    by_row = padded.as_strided((flat.shape[0], w, n), (w * width, width + 1, 1))  # A[i, i+k]
    terms, cols = diag_shape(n, b)
    out = torch.zeros((flat.shape[0], terms, cols), dtype=bands.dtype, device=bands.device)
    out[:, :w, :n] = by_row
    return out.reshape(*lead, terms, cols)


class Tiling(NamedTuple):
    """One launch's tiling (``tiling``)."""

    cluster: int       # S: blocks a cluster, each a slab of rows
    slab: int          # L: rows a slab (the last may be shorter)
    chains: int        # Cg: chains a cluster
    per_thread: int    # G: chains a thread's unit
    split: bool        # G = 1: stages 1 and 4 put a unit's operators on two threads
    clusters: int      # clusters of the launch, ceil(C / Cg)
    threads: int       # threads a block
    shared_bytes: int  # dynamic shared memory a block
    slabs: tuple       # (lo, hi) of each rank's slab


def cluster_size(n: int, bandwidth: int) -> int:
    """S: the largest power of two up to MAX_CLUSTER whose slabs keep at
    least max(b, MIN_SLAB) rows (so a halo comes from the adjacent blocks)
    and, rounded to even counts, leave the last slab rows; 1 for a grid
    shorter than two such slabs."""
    s = 1
    while (2 * s <= MAX_CLUSTER and n // (2 * s) >= max(bandwidth, MIN_SLAB)
           and (2 * s - 1) * 2 * _cdiv(n, 4 * s) < n):
        s *= 2
    return s


def chain_bytes(slab: int, bandwidth: int) -> int:
    """Shared memory one chain takes in a block with a slab of ``slab``
    rows: its parameters and sums, PART_LANES partials per unit, and
    VECTORS vectors of both states over the units' rows and a halo of b
    each side, all float64."""
    groups = _cdiv(slab, ROWS)
    return 8 * (N_PARAMS + N_SUMS + PART_LANES * groups
                + VECTORS * 2 * (groups * ROWS + 2 * bandwidth))


def tiling(n: int, bandwidth: int, n_chains: int) -> Tiling:
    """The launch for C = ``n_chains`` chains on a grid of n rows, band b.
    S and the slabs depend on (n, b) alone; Cg = ceil(C S / TARGET_BLOCKS)
    as shared memory allows, rounded down to a multiple of MAX_PER_THREAD
    above it; G the largest of 8, 4, 2 up to MAX_PER_THREAD dividing Cg that
    leaves the block MIN_UNITS units (ROWS rows of one state for G chains),
    else 1; ``split`` for one chain a cluster when twice its units fit
    one pass; threads enough for the units (two a unit when split), each
    state's padded to whole warps, in as few passes of at most MAX_THREADS
    as can be. Raises ValueError when
    one chain's state is beyond a block's shared memory."""
    s = cluster_size(n, bandwidth)
    slab = _cdiv(n, s) if s == 1 else 2 * _cdiv(n, 2 * s)  # even: aligned vectors
    per_chain = chain_bytes(slab, bandwidth)
    fits = MAX_SHARED_BYTES // per_chain
    if fits < 1:
        raise ValueError(f"centered_vg: a chain at n = {n}, b = {bandwidth} needs {per_chain} "
                         f"bytes of shared memory, more than {MAX_SHARED_BYTES}")
    c = max(1, min(_cdiv(n_chains * s, TARGET_BLOCKS), fits, n_chains))
    if c > MAX_PER_THREAD:
        c -= c % MAX_PER_THREAD
    groups = _cdiv(slab, ROWS)
    g = next((g for g in (8, 4, 2) if g <= MAX_PER_THREAD and c % g == 0
              and 2 * groups * (c // g) >= MIN_UNITS), 1)
    # each state's row groups padded to whole warps, as the kernel runs them;
    # one chain a cluster splits stages 1 and 4 over twice the threads when
    # they fit one pass (on the H100 faster there, slower at 2 chains or in
    # two passes: perf/vg_timing.py, PERF.md)
    units = 2 * 32 * _cdiv(groups, 32) * (c // g)
    split = c == 1 and 2 * units <= MAX_THREADS
    units *= 2 if split else 1
    threads = 32 * _cdiv(_cdiv(units, _cdiv(units, MAX_THREADS)), 32)
    slabs = tuple((r * slab, min(n, (r + 1) * slab)) for r in range(s))
    return Tiling(cluster=s, slab=slab, chains=c, per_thread=g, split=split,
                  clusters=_cdiv(n_chains, c), threads=threads, shared_bytes=c * per_chain,
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
        bands=bands, band_diags=band_diags(bands, int(target.bandwidth)),
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
POINTERS = ("dpsi", "band_diags", "fields", "scalars", "g_psi", "lp")
INTS = ("n_chains", "n", "bandwidth", "dim", "sigma_sampled", "theta_kind", "cluster", "slab",
        "chains", "per_thread", "split", "threads", "shared_bytes", "n_pointers", "n_ints")
# (library, tiling, float64) -> clusters the card runs at once
_MAX_CLUSTERS = {}


def centered_fn_vg_cuda(dpsi: torch.Tensor, p: CenteredFN):
    """The kernel on the current stream: (lp (C,), g_psi (C, dim)) from
    dpsi (C, dim), contiguous, on the device and in the dtype of ``p``."""
    return launch(None, dpsi, p)


def _ints(c: int, dim: int, p: CenteredFN, tile: Tiling):
    return (ctypes.c_longlong * len(INTS))(
        c, p.n, p.bandwidth, dim, int(p.sigma_sampled), p.theta_kind, tile.cluster, tile.slab,
        tile.chains, tile.per_thread, int(tile.split), tile.threads, tile.shared_bytes,
        len(POINTERS), len(INTS))


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
    tensors = dict(dpsi=dpsi, band_diags=p.band_diags, fields=p.fields, scalars=p.scalars)
    for what, t in tensors.items():
        if t.device != dpsi.device or t.dtype != dpsi.dtype or not t.is_contiguous():
            raise ValueError(f"centered_fn_vg_cuda: {what} must be a contiguous {dpsi.dtype} "
                             f"tensor on {dpsi.device}; got {t.dtype} on {t.device}")
    if dpsi.device.type != "cuda" or dpsi.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"centered_fn_vg_cuda: float32 or float64 on a CUDA device; got "
                         f"{dpsi.dtype} on {dpsi.device}")
    diags = (len(BANDS), d, *diag_shape(n, p.bandwidth))
    if (dim != want_dim or tuple(p.band_diags.shape) != diags
            or tuple(p.fields.shape) != (len(FIELDS), d, n)
            or tuple(p.scalars.shape) != (N_SCALARS,) or p.theta_kind not in (0, 1)):
        raise ValueError(f"centered_fn_vg_cuda: dpsi {tuple(dpsi.shape)} (dim {want_dim}), "
                         f"band copy {tuple(p.band_diags.shape)} (want {diags}), fields "
                         f"{tuple(p.fields.shape)}, "
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
    out = dict(tensors, g_psi=g_psi, lp=lp)
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
