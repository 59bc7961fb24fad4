"""Split-R-hat and bulk ESS (Vehtari et al. 2021: the autocovariance and
Geyer's initial monotone sequence), a frozen copy of the port's
``postprocess/diagnostics.py`` (``split_rhat``, ``ess``), so that a change
to the program cannot move the yardstick."""
from __future__ import annotations

import numpy as np


def _split_chains(x: np.ndarray) -> np.ndarray:
    """(C, S) -> (2C, S//2): each chain split in half."""
    half = x.shape[1] // 2
    return np.concatenate([x[:, :half], x[:, half: 2 * half]], axis=0)


def split_rhat(x: np.ndarray) -> float:
    """Split-R-hat of one scalar quantity, x (C, S)."""
    x = _split_chains(np.asarray(x, dtype=np.float64))
    m, n = x.shape
    if n < 2:
        return np.nan
    w = x.var(axis=1, ddof=1).mean()
    b = n * x.mean(axis=1).var(ddof=1) if m > 1 else 0.0
    var_plus = (n - 1) / n * w + b / n
    if w <= 0:
        return np.nan if var_plus <= 0 else np.inf
    return float(np.sqrt(var_plus / w))


def _autocovariance(x: np.ndarray) -> np.ndarray:
    s = x.shape[1]
    xc = x - x.mean(axis=1, keepdims=True)
    size = 2 ** int(np.ceil(np.log2(2 * s)))
    f = np.fft.rfft(xc, n=size, axis=1)
    return np.fft.irfft(f * np.conj(f), n=size, axis=1)[:, :s].real / s


def ess(x: np.ndarray) -> float:
    """Bulk effective sample size across chains, x (C, S)."""
    x = _split_chains(np.asarray(x, dtype=np.float64))
    m, n = x.shape
    if n < 4:
        return np.nan
    acov = _autocovariance(x)
    mean_var = (acov[:, 0] * n / (n - 1.0)).mean()
    var_plus = mean_var * (n - 1.0) / n
    if m > 1:
        var_plus += x.mean(axis=1).var(ddof=1)
    if var_plus <= 0:
        return np.nan
    rho = 1.0 - (mean_var - acov.mean(axis=0)) / var_plus
    n_pairs = (len(rho) - 1) // 2
    pairs = rho[0: 2 * n_pairs: 2] + rho[1: 2 * n_pairs: 2]
    neg = np.flatnonzero(pairs < 0)
    if neg.size:
        pairs = pairs[: neg[0]]
    tau = 1.0 if pairs.size == 0 else -1.0 + 2.0 * np.minimum.accumulate(pairs).sum()
    tau = max(tau, 1.0 / np.log10(n * m + 10.0))
    return float(m * n / tau)
