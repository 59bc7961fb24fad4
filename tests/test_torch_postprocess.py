"""PyTorch port, postprocessing (plain numpy, the port's own copy):
summarize_chains, format_summary, results_to_chain and magi_summary give
the JAX package's output on the same samples, ess / split_rhat equal its
values, and plot_magi draws its figures (matplotlib imported only then)."""
import numpy as np
import pytest

from manifold_constrained_gaussian_process_inference_tpu import postprocess as jp
from manifold_constrained_gaussian_process_inference_tpu.inference.solve import (
    MagiResult as JResult,
)
from manifold_constrained_gaussian_process_inference_tpu_torch import postprocess as tp
from manifold_constrained_gaussian_process_inference_tpu_torch.inference.solve import (
    MagiResult as TResult,
)


def _samples(seed=0, c=4, s=150, p=3):
    rng = np.random.default_rng(seed)
    x = np.zeros((c, s, p))
    for i in range(1, s):  # autocorrelated, one chain offset
        x[:, i] = 0.8 * x[:, i - 1] + rng.normal(size=(c, p))
    x[0] += 0.3
    return x


@pytest.mark.parametrize("shape", [(4, 150, 3), (1, 200, 2), (200, 2)])
def test_summarize_chains_matches_jax(shape):
    x = _samples(c=shape[0], s=shape[1], p=shape[-1]) if len(shape) == 3 else _samples(
        c=1, s=shape[0], p=shape[1])[0]
    names = [f"a{i}" for i in range(shape[-1])]
    got = tp.summarize_chains(x, names=names)
    want = jp.summarize_chains(x, names=names)
    assert list(got) == list(want)
    for key in want:
        if key == "names":
            assert got[key] == want[key]
        else:
            np.testing.assert_array_equal(got[key], want[key])
    assert tp.format_summary(got, digits=4) == jp.format_summary(want, digits=4)
    assert tp.summarize_chains(x)["names"] == jp.summarize_chains(x)["names"]


def test_ess_and_rhat_match_jax():
    x = _samples(seed=3)[:, :, 0]
    assert tp.ess(x) == jp.ess(x)
    assert tp.split_rhat(x) == jp.split_rhat(x)


def _result(cls, n_chains, rng):
    s, n, d, k = 120, 7, 2, 3
    return cls(
        theta=rng.normal(size=(s, k)) * 0.1 + np.array([0.2, 0.2, 3.0]),
        x_sampled=rng.normal(size=(s, n, d)),
        sigma=np.abs(rng.normal(size=(s, d)) * 0.05 + 0.2),
        phi=np.ones((2, d)),
        lp=rng.normal(size=s) - 100,
        diagnostics={"n_chains": n_chains},
    )


@pytest.mark.parametrize("n_chains", [1, 4])
def test_results_to_chain_and_magi_summary_match_jax(n_chains, capsys):
    got_res = _result(TResult, n_chains, np.random.default_rng(5))
    want_res = _result(JResult, n_chains, np.random.default_rng(5))
    for kw in (dict(), dict(include_sigma=True, include_lp=True), dict(par_names=["a", "b", "c"])):
        got, want = tp.results_to_chain(got_res, **kw), jp.results_to_chain(want_res, **kw)
        assert got["names"] == want["names"]
        np.testing.assert_array_equal(got["samples"], want["samples"])
    with pytest.raises(ValueError):
        tp.results_to_chain(got_res, par_names=["a"])
    got = tp.magi_summary(got_res, par_names=["a", "b", "c"])
    printed = capsys.readouterr().out
    want = jp.magi_summary(want_res, par_names=["a", "b", "c"])
    assert printed == capsys.readouterr().out
    assert printed.startswith("--- MAGI Posterior Summary ---")
    for key in want:
        if key != "names":
            np.testing.assert_array_equal(got[key], want[key])


def _artists(fig):
    """Per axes: title, visibility, and the data of every line, ribbon and
    scatter, in drawing order."""
    out = []
    for ax in fig.axes:
        lines = [np.asarray(line.get_xydata()) for line in ax.get_lines()]
        fills = [np.asarray(c.get_paths()[0].vertices) if hasattr(c, "get_paths") and c.get_paths()
                 else np.asarray(c.get_offsets()) for c in ax.collections]
        out.append((ax.get_title(), ax.get_visible(), lines, fills))
    return out


@pytest.mark.parametrize("kind,kw", [
    ("traj", dict(comp_names=["P", "M"], ci=True)),
    ("traj", dict(obs=False, ci=False, ylim=(-3, 3))),
    ("trace", dict(include_sigma=True, include_lp=True)),
    ("trace", dict(par_names=["a", "b", "c"], nplotcol=2)),
])
def test_plot_magi_matches_jax(kind, kw, tmp_path):
    """plot_magi draws the JAX package's figure: the same axes, titles and
    plotted data; the figure is written when asked; an unknown type raises."""
    import matplotlib.pyplot as plt

    got_res = _result(TResult, 4, np.random.default_rng(6))
    want_res = _result(JResult, 4, np.random.default_rng(6))
    t = np.linspace(0.0, 6.0, 7)
    y = np.random.default_rng(7).normal(size=(7, 2))
    y[::2, 1] = np.nan
    extra = dict(t_obs=t, y_obs=y) if kind == "traj" else {}
    path = tmp_path / "fig.png"
    got = tp.plot_magi(got_res, type=kind, save_path=str(path), **extra, **kw)
    want = jp.plot_magi(want_res, type=kind, **extra, **kw)
    assert path.stat().st_size > 0
    for (gt, gv, gl, gf), (wt, wv, wl, wf) in zip(_artists(got), _artists(want), strict=True):
        assert (gt, gv, len(gl), len(gf)) == (wt, wv, len(wl), len(wf))
        for g, w in zip(gl + gf, wl + wf):
            np.testing.assert_array_equal(g, w)
    plt.close("all")
    with pytest.raises(ValueError, match="type"):
        tp.plot_magi(got_res, type="pairs")


def test_plot_magi_imports_matplotlib_lazily():
    import subprocess
    import sys

    code = ("import sys; sys.modules['matplotlib'] = None\n"
            "import manifold_constrained_gaussian_process_inference_tpu_torch.postprocess as p\n"
            "try:\n    p.plot_magi(None)\nexcept ImportError as e:\n    print('lazy', e)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "lazy" in out.stdout, out.stderr
