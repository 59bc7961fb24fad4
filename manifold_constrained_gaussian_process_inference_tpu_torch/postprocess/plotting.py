"""Trajectory and trace plots of a ``MagiResult`` (port of the JAX
package's postprocess/plotting.py; matplotlib, host-side, optional).

type="traj" draws the posterior-mean trajectory with a credible ribbon and
the observations; type="trace" draws parameter traces per chain.
matplotlib is imported when a plot is drawn, never at import, so the
package does not need it.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .summary import results_to_chain


def _mpl():
    try:
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        return plt
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "matplotlib is required for plot_magi; install it or use "
            "magi_summary for text output."
        ) from e


def plot_magi(
    results,
    type: str = "traj",
    par_names: Optional[Sequence[str]] = None,
    comp_names: Optional[Sequence[str]] = None,
    t_obs: Optional[np.ndarray] = None,
    y_obs: Optional[np.ndarray] = None,
    obs: bool = True,
    ci: bool = True,
    lower: float = 0.025,
    upper: float = 0.975,
    include_sigma: bool = False,
    include_lp: bool = True,
    nplotcol: int = 3,
    save_path: Optional[str] = None,
    line_kwargs: Optional[dict] = None,
    ci_kwargs: Optional[dict] = None,
    obs_kwargs: Optional[dict] = None,
    **axes_kwargs,
):
    """Returns the matplotlib Figure. Invalid ``type`` raises ValueError
    (parity: MagiJl.jl:1151-1153).

    Per-plot styling passthrough (the reference forwards Plots.jl attribute
    kwargs to every subplot, MagiJl.jl:1015-1154): ``line_kwargs``/
    ``ci_kwargs``/``obs_kwargs`` merge into the mean-line (and trace-line)
    plot, the credible ribbon, and the observation scatter respectively;
    any remaining keyword arguments are applied to every subplot's Axes via
    ``ax.set(...)`` (e.g. ``xlabel=..., ylim=(0, 4), yscale='log'``)."""
    plt = _mpl()
    line_kwargs = dict(line_kwargs or {})
    ci_kwargs = dict(ci_kwargs or {})
    obs_kwargs = dict(obs_kwargs or {})
    if type == "traj":
        x = np.asarray(results.x_sampled)  # (S, n, D)
        n_samples, n_times, n_dims = x.shape
        names = (
            list(comp_names)
            if comp_names is not None and len(comp_names) == n_dims
            else [f"Component {d + 1}" for d in range(n_dims)]
        )
        ncol = min(nplotcol, n_dims)
        nrow = int(np.ceil(n_dims / ncol))
        fig, axes = plt.subplots(
            nrow, ncol, figsize=(4.5 * ncol, 3.2 * nrow), squeeze=False
        )
        ts = np.asarray(t_obs) if t_obs is not None and len(t_obs) == n_times else np.arange(n_times)
        for d in range(n_dims):
            ax = axes[d // ncol][d % ncol]
            mean = x[:, :, d].mean(axis=0)
            ax.plot(
                ts, mean,
                **{"color": "tab:blue", "label": "Mean", **line_kwargs},
            )
            if ci:
                lo = np.quantile(x[:, :, d], lower, axis=0)
                hi = np.quantile(x[:, :, d], upper, axis=0)
                ax.fill_between(
                    ts, lo, hi,
                    **{
                        "alpha": 0.3, "color": "skyblue",
                        "label": f"{(upper - lower) * 100:.0f}% CI",
                        **ci_kwargs,
                    },
                )
            if obs and y_obs is not None and t_obs is not None:
                yo = np.asarray(y_obs)
                if yo.shape == (n_times, n_dims):
                    valid = np.isfinite(yo[:, d])
                    ax.scatter(
                        np.asarray(t_obs)[valid], yo[valid, d],
                        **{
                            "s": 8, "color": "tab:red", "zorder": 3,
                            "label": "Obs", **obs_kwargs,
                        },
                    )
            ax.set_title(names[d], fontsize=9)
            ax.set_xlabel("Time" if t_obs is not None else "Index")
            ax.set_ylabel("Level")
            if axes_kwargs:
                ax.set(**axes_kwargs)
        for i in range(n_dims, nrow * ncol):
            axes[i // ncol][i % ncol].set_visible(False)
        axes[0][0].legend(fontsize=7)
    elif type == "trace":
        chain = results_to_chain(
            results, par_names=par_names,
            include_sigma=include_sigma, include_lp=include_lp,
        )
        samples = chain["samples"]  # (C, S, P)
        names = chain["names"]
        p = samples.shape[-1]
        ncol = min(nplotcol, p)
        nrow = int(np.ceil(p / ncol))
        fig, axes = plt.subplots(
            nrow, ncol, figsize=(4.5 * ncol, 2.4 * nrow), squeeze=False
        )
        for i in range(p):
            ax = axes[i // ncol][i % ncol]
            for c in range(samples.shape[0]):
                ax.plot(
                    samples[c, :, i],
                    **{"lw": 0.5, "alpha": 0.8, **line_kwargs},
                )
            ax.set_title(names[i], fontsize=9)
            if axes_kwargs:
                ax.set(**axes_kwargs)
        for i in range(p, nrow * ncol):
            axes[i // ncol][i % ncol].set_visible(False)
    else:
        raise ValueError(
            f"Invalid plot type '{type}'. Use type='traj' or type='trace'."
        )
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
    return fig
