"""MCMC diagnostics: effective sample size, split-R-hat, quantiles and the
summary table (port of the JAX package's postprocess/diagnostics.py, which
is plain numpy; carried over unchanged). Algorithms follow Vehtari et al.
2021: split-R-hat and bulk ESS via the autocovariance / Geyer
initial-monotone-sequence estimator.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def _split_chains(x: np.ndarray) -> np.ndarray:
    """(C, S) -> (2C, S//2): split each chain in half."""
    c, s = x.shape
    half = s // 2
    return np.concatenate([x[:, :half], x[:, half : 2 * half]], axis=0)


def split_rhat(x: np.ndarray) -> float:
    """Split-R-hat for one scalar quantity; x has shape (C, S)."""
    x = _split_chains(np.asarray(x, dtype=np.float64))
    m, n = x.shape
    if n < 2:
        return np.nan
    chain_means = x.mean(axis=1)
    chain_vars = x.var(axis=1, ddof=1)
    w = chain_vars.mean()
    b = n * chain_means.var(ddof=1) if m > 1 else 0.0
    var_plus = (n - 1) / n * w + b / n
    if w <= 0:
        return np.nan if var_plus <= 0 else np.inf
    return float(np.sqrt(var_plus / w))


def _autocovariance(x: np.ndarray) -> np.ndarray:
    """Autocovariance per chain via FFT; x (C, S) -> (C, S)."""
    c, s = x.shape
    xc = x - x.mean(axis=1, keepdims=True)
    size = 2 ** int(np.ceil(np.log2(2 * s)))
    f = np.fft.rfft(xc, n=size, axis=1)
    acov = np.fft.irfft(f * np.conj(f), n=size, axis=1)[:, :s].real
    return acov / s


def ess(x: np.ndarray) -> float:
    """Bulk effective sample size across chains; x has shape (C, S)."""
    x = _split_chains(np.asarray(x, dtype=np.float64))
    m, n = x.shape
    if n < 4:
        return np.nan
    acov = _autocovariance(x)
    chain_var = acov[:, 0] * n / (n - 1.0)
    mean_var = chain_var.mean()
    var_plus = mean_var * (n - 1.0) / n
    if m > 1:
        var_plus += x.mean(axis=1).var(ddof=1)
    if var_plus <= 0:
        return np.nan

    rho = 1.0 - (mean_var - acov.mean(axis=0)) / var_plus  # rho_hat_t, rho_0 = 1
    # Geyer pairs P_k = rho_{2k} + rho_{2k+1}: truncate at the first negative
    # pair, then enforce monotone non-increase; tau = -1 + 2 * sum(P_k).
    n_pairs = (len(rho) - 1) // 2
    pairs = rho[0 : 2 * n_pairs : 2] + rho[1 : 2 * n_pairs : 2]
    neg = np.flatnonzero(pairs < 0)
    if neg.size:
        pairs = pairs[: neg[0]]
    if pairs.size == 0:
        tau = 1.0
    else:
        pairs = np.minimum.accumulate(pairs)
        tau = -1.0 + 2.0 * pairs.sum()
    tau = max(tau, 1.0 / np.log10(n * m + 10.0))
    return float(m * n / tau)


def _per_param(fn, samples: np.ndarray) -> np.ndarray:
    """Apply a (C, S) -> scalar diagnostic over the last axis params.
    samples: (C, S, P)."""
    return np.array([fn(samples[:, :, p]) for p in range(samples.shape[-1])])


def summarize_chains(samples: np.ndarray, names=None, probs=(0.025, 0.5, 0.975)) -> Dict:
    """Summary table over (C, S, P) (or (S, P)) samples: mean, sd,
    quantiles, ESS and split-R-hat per parameter."""
    samples = np.asarray(samples, dtype=np.float64)
    if samples.ndim == 2:
        samples = samples[None]
    c, s, p = samples.shape
    flat = samples.reshape(c * s, p)
    names = list(names) if names is not None else [f"param[{i}]" for i in range(p)]
    out = {
        "names": names,
        "mean": flat.mean(axis=0),
        "sd": flat.std(axis=0, ddof=1),
        "ess": _per_param(ess, samples),
        "rhat": _per_param(split_rhat, samples),
    }
    for q in probs:
        out[f"q{q}"] = np.quantile(flat, q, axis=0)
    return out


def format_summary(summary: Dict, digits: int = 3) -> str:
    cols = ["mean", "sd", "q0.025", "q0.5", "q0.975", "ess", "rhat"]
    avail = [c for c in cols if c in summary]
    header = f"{'parameter':>16} " + " ".join(f"{c:>10}" for c in avail)
    lines = [header]
    for i, name in enumerate(summary["names"]):
        vals = " ".join(f"{summary[c][i]:>10.{digits}f}" for c in avail)
        lines.append(f"{name:>16} {vals}")
    return "\n".join(lines)
