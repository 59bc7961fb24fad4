"""results_to_chain / magi_summary: result shaping and the printed summary
(port of the JAX package's postprocess/summary.py, plain numpy). A "chain"
is a dict of named (C, S, P) samples.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from .diagnostics import format_summary, summarize_chains


def results_to_chain(
    results,
    par_names: Optional[Sequence[str]] = None,
    include_sigma: bool = False,
    include_lp: bool = False,
) -> Dict:
    """Named sample matrix of a MagiResult: theta columns theta[i] (or
    ``par_names``), optional sigma[i] columns and lp. Returns
    {"names": [...], "samples": (C, S, P)}."""
    theta = np.asarray(results.theta)
    n_samples, k = theta.shape
    n_chains = int(results.diagnostics.get("n_chains", 1)) if hasattr(results, "diagnostics") else 1
    if par_names is None:
        names = [f"theta[{i + 1}]" for i in range(k)]
    else:
        if len(par_names) != k:
            raise ValueError(f"par_names has length {len(par_names)}, expected {k}")
        names = list(par_names)
    cols = [theta]
    if include_sigma:
        sigma = np.asarray(results.sigma)
        if sigma.shape[0] == n_samples:
            names += [f"sigma[{i + 1}]" for i in range(sigma.shape[1])]
            cols.append(sigma)
    if include_lp:
        lp = np.asarray(results.lp)
        if lp.size == n_samples:
            names.append("lp")
            cols.append(lp[:, None])
    data = np.concatenate(cols, axis=1)
    samples = data.reshape(n_chains, n_samples // n_chains, data.shape[1])
    return {"names": names, "samples": samples}


def magi_summary(
    results,
    par_names: Optional[Sequence[str]] = None,
    include_sigma: bool = True,
    digits: int = 3,
    lower: float = 0.025,
    upper: float = 0.975,
    print_summary: bool = True,
) -> Dict:
    """Posterior summary (mean, sd, quantiles, ESS, R-hat) of theta, sigma
    and lp; printed unless ``print_summary`` is False."""
    chain = results_to_chain(
        results, par_names=par_names, include_sigma=include_sigma, include_lp=True
    )
    summary = summarize_chains(chain["samples"], names=chain["names"], probs=(lower, 0.5, upper))
    if print_summary:
        print("--- MAGI Posterior Summary ---")
        print(format_summary(summary, digits=digits))
    return summary
