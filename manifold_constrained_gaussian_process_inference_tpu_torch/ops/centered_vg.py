"""The whitened, mode-centered FitzHugh-Nagumo value-and-grad between its
two whitening GEMMs: one hand-written CUDA kernel (csrc/centered_vg.cu),
its plain version and the dispatch between them.

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

The kernel is built at first use through ``ops/cuda_band.build`` into
``<package>/build/`` and bound with ctypes. Its launches are counted in
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
# the kernel's threads per block and its chain's sums (the sums of r^2 per
# state, |g|^2, |h|^2 and the three theta gradients; one slot spare),
# reduced in three steps (3, 1 and 3 of them), each with its warps'
# partials; and the shared memory a block may use on an H100 (the opt-in
# maximum). A block takes one chain: blocks of 2, 4 and 8 chains were the
# slower at every shape measured on the H100 (PERF.md, PR 11)
THREADS, N_SUMS, N_PARTIALS = 512, 8, 7
MAX_SHARED_BYTES = 232448

# The longest grid the route takes, as n (2b+1), one operator's terms: on
# the H100 the kernel route was the faster up to config 4's grid (n = 793,
# b = 80: 0.260 against 0.395 ms per value-and-grad at 128 chains, 0.210
# against 0.226 at one) and twice the slower at n = 3169, b = 160 (2.07
# against 1.01), where one block streams 48.8 MB of storages a chain
# through one SM (perf/vg_timing.py, PERF.md)
MAX_TERMS = 793 * 161

_LIB = None


class CenteredFN(NamedTuple):
    """A whitened FN target's constants as the kernel reads them."""

    bands: torch.Tensor    # (6, D, 2b+1, n): the storages of BANDS
    fields: torch.Tensor   # (5, D, n): FIELDS, transposed to (D, n)
    scalars: torch.Tensor  # (N_SCALARS,)
    n: int
    bandwidth: int
    sigma_sampled: bool
    theta_kind: int        # 0: theta = z; 1: theta = lb + exp(z)


def shared_bytes(n: int, itemsize: int) -> int:
    """Shared memory of one block: in float64 (the kernel computes in it)
    the chain's parameters and sums and the block reductions' warp
    partials; in the storage type four (D, n) vectors (dx; e, then ebar;
    -g / beta_level; -h / beta_deriv)."""
    return 8 * (N_SUMS + 8 + (THREADS // 32) * N_PARTIALS) + itemsize * 4 * N_DIMS * n


def takes(target) -> bool:
    """Whether ``target``'s whitened value-and-grad takes this route: a
    banded target of the FN system, theta unbounded or bounded below in
    every parameter, float32 or float64, a grid of at most MAX_TERMS terms
    an operator, and one chain's state within a block's shared memory."""
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
    itemsize = torch.empty((), dtype=dtype).element_size()
    return shared_bytes(target.n_times, itemsize) <= MAX_SHARED_BYTES


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
    return CenteredFN(
        bands=torch.stack(storages).contiguous(),
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
    """Build ``source`` (the kernel's, or a copy of it that
    ``perf/unroll_repro.py`` builds), bind its C entry points and set its
    instances' shared-memory limit."""
    lib = ctypes.CDLL(str(cuda_band.build(source)))
    p = ctypes.c_void_p
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"{NAME}_{suffix}")
        fn.argtypes, fn.restype = [p, p, p], ctypes.c_int
    lib.centered_vg_init.argtypes, lib.centered_vg_init.restype = [], ctypes.c_int
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
POINTERS = ("dpsi", "bands", "fields", "scalars", "g_psi", "lp")
INTS = ("n_chains", "n", "bandwidth", "dim", "sigma_sampled", "theta_kind", "n_pointers",
        "n_ints")


def centered_fn_vg_cuda(dpsi: torch.Tensor, p: CenteredFN):
    """The kernel on the current stream: (lp (C,), g_psi (C, dim)) from
    dpsi (C, dim), contiguous, on the device and in the dtype of ``p``."""
    return launch(None, dpsi, p)


def launch(lib, dpsi: torch.Tensor, p: CenteredFN):
    """``centered_fn_vg_cuda`` through the library ``lib`` (``load``;
    None: the kernel's own, built at first use). Raises on an input it
    does not take, before any build."""
    c, dim = dpsi.shape
    n, d = p.n, N_DIMS
    want_dim = n * d + N_THETA + (d if p.sigma_sampled else 0)
    tensors = dict(dpsi=dpsi, bands=p.bands, fields=p.fields, scalars=p.scalars)
    for what, t in tensors.items():
        if t.device != dpsi.device or t.dtype != dpsi.dtype or not t.is_contiguous():
            raise ValueError(f"centered_fn_vg_cuda: {what} must be a contiguous {dpsi.dtype} "
                             f"tensor on {dpsi.device}; got {t.dtype} on {t.device}")
    if dpsi.device.type != "cuda" or dpsi.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"centered_fn_vg_cuda: float32 or float64 on a CUDA device; got "
                         f"{dpsi.dtype} on {dpsi.device}")
    width = 2 * p.bandwidth + 1
    if (dim != want_dim or tuple(p.bands.shape) != (len(BANDS), d, width, n)
            or tuple(p.fields.shape) != (len(FIELDS), d, n)
            or tuple(p.scalars.shape) != (N_SCALARS,) or p.theta_kind not in (0, 1)):
        raise ValueError(f"centered_fn_vg_cuda: dpsi {tuple(dpsi.shape)} (dim {want_dim}), "
                         f"bands {tuple(p.bands.shape)}, fields {tuple(p.fields.shape)}, "
                         f"theta kind {p.theta_kind}")
    if shared_bytes(n, dpsi.element_size()) > MAX_SHARED_BYTES:
        raise ValueError(f"centered_fn_vg_cuda: a chain at n = {n} needs "
                         f"{shared_bytes(n, dpsi.element_size())} bytes of shared memory")
    lib = _library() if lib is None else lib
    g_psi = torch.empty_like(dpsi)
    lp = torch.empty(c, dtype=dpsi.dtype, device=dpsi.device)
    if c == 0:
        return lp, g_psi
    out = dict(tensors, g_psi=g_psi, lp=lp)
    ptrs = (ctypes.c_void_p * len(POINTERS))(*(out[k].data_ptr() for k in POINTERS))
    ints = (ctypes.c_longlong * len(INTS))(
        c, n, p.bandwidth, dim, int(p.sigma_sampled), p.theta_kind, len(POINTERS), len(INTS))
    fn = getattr(lib, f"{NAME}_{'f32' if dpsi.dtype == torch.float32 else 'f64'}")
    err = fn(ptrs, ints, torch.cuda.current_stream(dpsi.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err}")
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
