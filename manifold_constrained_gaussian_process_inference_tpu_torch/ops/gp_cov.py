"""GP covariance engine (port of the JAX package's ops/gp_cov.py).

The one-time construction (kernel matrices, analytic derivatives, Cholesky
inverses) runs on the host in float64 numpy/LAPACK, exactly as in the JAX
package; the result is emitted as torch tensors in the working dtype and
device.

  Cinv = (C + jitter I)^-1
  mphi = Cprime @ Cinv
  Kphi = Cdoubleprime - mphi @ Cprime^T + jitter I
  Kinv = Kphi^-1
Banded copies truncate Cinv/mphi/Kinv to the given bandwidth.
"""
from __future__ import annotations

import logging
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from . import kernels as _kernels
from .band import mat2band

logger = logging.getLogger(__name__)

_TENSOR_FIELDS = (
    "phi", "tvec", "C", "Cinv", "Cprime", "Cdoubleprime", "mphi", "Kphi",
    "Kinv", "Cinv_band", "mphi_band", "Kinv_band", "Cinv_band_chol",
    "Kinv_band_chol", "mu", "dotmu",
)


class GPCov(NamedTuple):
    """Batched GP covariance bundle for all D state dimensions.

    Shapes: phi (D, 2) [variance, lengthscale]; tvec (n,); dense matrices
    (D, n, n); mu/dotmu (D, n). *_band are band-masked dense copies.
    ``bandsize`` is a plain int.
    """

    phi: torch.Tensor
    tvec: torch.Tensor
    C: torch.Tensor
    Cinv: torch.Tensor
    Cprime: torch.Tensor
    Cdoubleprime: torch.Tensor
    mphi: torch.Tensor
    Kphi: torch.Tensor
    Kinv: torch.Tensor
    Cinv_band: torch.Tensor
    mphi_band: torch.Tensor
    Kinv_band: torch.Tensor
    Cinv_band_chol: torch.Tensor
    Kinv_band_chol: torch.Tensor
    mu: torch.Tensor
    dotmu: torch.Tensor
    bandsize: int

    @property
    def n_times(self) -> int:
        return self.tvec.shape[0]

    @property
    def n_dims(self) -> int:
        return self.C.shape[0]

    @classmethod
    def from_numpy(cls, fields, dtype=torch.float64, device="cpu") -> "GPCov":
        """Build from numpy-convertible fields: a mapping, or any object
        with the same attribute names (e.g. the JAX package's GPCov)."""
        if not isinstance(fields, Mapping):
            fields = {name: getattr(fields, name) for name in cls._fields}
        tensors = {
            name: torch.as_tensor(
                np.array(fields[name], dtype=np.float64), dtype=dtype, device=device
            )
            for name in _TENSOR_FIELDS
        }
        return cls(**tensors, bandsize=int(fields["bandsize"]))

    def to(self, dtype=None, device=None) -> "GPCov":
        """The same bundle cast to another dtype and/or device."""
        return self._replace(
            **{name: getattr(self, name).to(dtype=dtype, device=device)
               for name in _TENSOR_FIELDS}
        )


def banded_cholesky(a_band: np.ndarray, bandwidth: int, max_tries: int = 10):
    """Lower Cholesky factor of a band-masked SPD matrix (host, float64),
    repaired by an escalating relative diagonal jitter, then by a diagonal
    shift of |lambda_min| + margin. Returns (L, jitter_used)."""
    a_band = np.asarray(a_band, dtype=np.float64)
    n = a_band.shape[0]
    scale = float(np.max(np.abs(np.diagonal(a_band)))) or 1.0
    for trial in range(max_tries):
        j = 0.0 if trial == 0 else scale * 1e-14 * (10.0 ** (trial - 1))
        try:
            chol = np.linalg.cholesky(a_band + j * np.eye(n))
            if j > 0:
                logger.warning(
                    "banded_cholesky: banded truncation lost definiteness; "
                    "repaired with relative jitter %.3e.", j / scale,
                )
            return mat2band(chol, bandwidth, 0), j
        except np.linalg.LinAlgError:
            continue
    sym = 0.5 * (a_band + a_band.T)
    lam_min = float(np.linalg.eigvalsh(sym).min())
    shift = max(0.0, -lam_min) + scale * 1e-10
    rel = shift / scale
    msg = (
        "banded_cholesky: diagonal-shift fallback engaged "
        "(lambda_min=%.3e, shift=%.3e, relative=%.2e)."
    )
    (logger.warning if rel > 1e-6 else logger.debug)(msg, lam_min, shift, rel)
    chol = np.linalg.cholesky(sym + shift * np.eye(n))
    return mat2band(chol, bandwidth, 0), shift


def robust_spd_inverse(a: np.ndarray, jitter: float, max_tries: int = 8):
    """Invert a symmetric matrix, repairing non-PD inputs deterministically
    (Cholesky with jitter escalated x10 per retry, then an eigenvalue
    floor). Returns (inverse, effective_jitter)."""
    a = np.asarray(a, dtype=np.float64)
    a = 0.5 * (a + a.T)
    n = a.shape[0]
    eye = np.eye(n)
    for trial in range(max_tries):
        j = 0.0 if trial == 0 else jitter * (10.0 ** (trial - 1))
        try:
            chol = np.linalg.cholesky(a + j * eye)
            inv_l = np.linalg.inv(chol)
            return inv_l.T @ inv_l, j
        except np.linalg.LinAlgError:
            continue
    w, v = np.linalg.eigh(a)
    floor = max(jitter, 1e-12 * max(np.max(np.abs(w)), 1.0))
    w = np.maximum(w, floor)
    logger.warning(
        "robust_spd_inverse: Cholesky failed after jitter escalation; "
        "using eigenvalue floor %.3e.", floor,
    )
    return (v / w) @ v.T, float("nan")


def calculate_gp_covariances(
    kernel_type: str,
    phi: np.ndarray,
    tvec: np.ndarray,
    bandsize: int,
    complexity: int = 0,
    jitter: float = 1e-7,
    check_eigenvalues: bool = True,
):
    """Single-dimension covariance build (host, float64). Returns a dict of
    numpy arrays with the GPCov fields (minus batching) plus
    ``band_repair_rel``."""
    tvec = np.asarray(tvec, dtype=np.float64)
    phi = np.asarray(phi, dtype=np.float64)
    variance, lengthscale = float(phi[0]), float(phi[1])
    n = tvec.shape[0]
    l = u = int(bandsize)

    if complexity >= 2:
        c, cprime, cdouble = _kernels.cov_blocks(kernel_type, tvec, variance, lengthscale)
    else:
        c = _kernels.kernel_matrix(kernel_type, tvec, variance, lengthscale)
        cprime = np.zeros_like(c)
        cdouble = np.zeros_like(c)

    derivatives_calculated = complexity >= 2 and (
        np.any(cprime != 0.0) or np.any(cdouble != 0.0)
    )

    c_jittered = 0.5 * (c + c.T) + jitter * np.eye(n)
    cinv, _ = robust_spd_inverse(c_jittered, jitter)

    if derivatives_calculated:
        mphi = cprime @ cinv
        kphi = cdouble - mphi @ cprime.T
        kphi = 0.5 * (kphi + kphi.T) + jitter * np.eye(n)
        if check_eigenvalues:
            min_eig = float(np.linalg.eigvalsh(kphi).min())
            if min_eig <= 0:
                logger.warning(
                    "Kphi (after jitter) still has non-positive eigenvalues "
                    "(min=%.3e, jitter=%.1e, phi=%s). Check derivatives or "
                    "increase jitter.", min_eig, jitter, phi,
                )
        kinv, _ = robust_spd_inverse(kphi, jitter)
    else:
        mphi = np.zeros_like(c)
        kphi = jitter * np.eye(n)
        kinv = (1.0 / jitter) * np.eye(n)

    cinv_band = mat2band(cinv, l, u)
    kinv_band = mat2band(kinv, l, u)
    cinv_band_chol, shift_c = banded_cholesky(cinv_band, l)
    kinv_band_chol, shift_k = banded_cholesky(kinv_band, l)
    scale_c = float(np.max(np.abs(np.diagonal(cinv_band)))) or 1.0
    scale_k = float(np.max(np.abs(np.diagonal(kinv_band)))) or 1.0
    band_repair_rel = max(shift_c / scale_c, shift_k / scale_k)

    return dict(
        band_repair_rel=band_repair_rel,
        phi=phi,
        tvec=tvec,
        C=c_jittered - jitter * np.eye(n),
        Cinv=cinv,
        Cprime=cprime,
        Cdoubleprime=cdouble,
        mphi=mphi,
        Kphi=kphi,
        Kinv=kinv,
        Cinv_band=cinv_band,
        mphi_band=mat2band(mphi, l, u),
        Kinv_band=kinv_band,
        Cinv_band_chol=cinv_band_chol,
        Kinv_band_chol=kinv_band_chol,
        mu=np.zeros(n),
        dotmu=np.zeros(n),
        bandsize=int(bandsize),
    )


def build_gp_cov(
    kernel_type: str,
    phi_all: np.ndarray,
    tvec: np.ndarray,
    bandsize: int,
    complexity: int = 2,
    jitter: float = 1e-6,
    dtype: Optional[torch.dtype] = torch.float64,
    device="cpu",
    check_eigenvalues: bool = True,
    auto_escalate_bandsize: bool = True,
    band_repair_tol: float = 1e-2,
) -> GPCov:
    """Build the batched GPCov for all dimensions. ``phi_all`` is (2, D)
    [variance; lengthscale]. Band size is clipped to n-1. When the relative
    PSD-repair shift of the banded factors exceeds ``band_repair_tol`` the
    band is widened (doubled, capped at n-1) and the build retried."""
    phi_all = np.asarray(phi_all, dtype=np.float64)
    tvec = np.asarray(tvec, dtype=np.float64)
    n = tvec.shape[0]
    n_dims = phi_all.shape[1]
    bs = max(min(int(bandsize), n - 1), 0)

    while True:
        per_dim = [
            calculate_gp_covariances(
                kernel_type, phi_all[:, d], tvec, bs,
                complexity=complexity, jitter=jitter,
                check_eigenvalues=check_eigenvalues,
            )
            for d in range(n_dims)
        ]
        max_rel = max(p["band_repair_rel"] for p in per_dim)
        if (
            not auto_escalate_bandsize
            or max_rel <= band_repair_tol
            or bs >= n - 1
        ):
            if max_rel > band_repair_tol:
                logger.warning(
                    "GPCov band repair shift %.2e exceeds tol %.1e at "
                    "bandsize %d%s; quadratic forms deviate from the exact "
                    "band-truncated semantics.", max_rel, band_repair_tol,
                    bs, "" if auto_escalate_bandsize else " (escalation off)",
                )
            break
        new_bs = min(max(2 * bs, bs + 10), n - 1)
        logger.warning(
            "GPCov: PSD repair shift %.2e at bandsize %d exceeds tol %.1e; "
            "escalating bandsize to %d for posterior parity.",
            max_rel, bs, band_repair_tol, new_bs,
        )
        bs = new_bs

    fields = {
        name: np.stack([p[name] for p in per_dim])
        for name in _TENSOR_FIELDS if name not in ("phi", "tvec")
    }
    fields.update(phi=phi_all.T, tvec=tvec, bandsize=bs)
    return GPCov.from_numpy(fields, dtype=dtype, device=device)
