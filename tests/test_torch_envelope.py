"""PyTorch port, the divergence-informed curvature envelope (M18): the
port's CurvatureEnvelope against the JAX package's class on the same numpy
inputs (fold to rtol 1e-12, collection and probe points exactly), the last
divergent position exactly, the solve_magi probes against the JAX
package's wiring on a whitened FN target (rtol 1e-10), the divergent-leaf
tracking of the batched transition (off: the same operations as without
the option; on: the same draws), and envelope runs: an inactive envelope
is a bitwise no-op, the pocket reproducer of tests/test_envelope.py holds
the JAX package's bars, solve_magi returns the envelope keys or warns and
disables as the JAX package does, and warmup checkpoints carry the probes
(the port's, resumed bit for bit, and the JAX package's, converted)."""
import hashlib
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import manifold_constrained_gaussian_process_inference_tpu as jm
from manifold_constrained_gaussian_process_inference_tpu.inference import checkpoint as jck
from manifold_constrained_gaussian_process_inference_tpu.inference import (
    nuts_batched as jnb,
)
from manifold_constrained_gaussian_process_inference_tpu.inference import whiten as jw
from manifold_constrained_gaussian_process_inference_tpu.inference.target import (
    MagiTarget as JTarget,
)
from manifold_constrained_gaussian_process_inference_tpu.models import FN_SYSTEM as J_FN
from manifold_constrained_gaussian_process_inference_tpu.parallel import chains as jc
import manifold_constrained_gaussian_process_inference_tpu_torch as mt
from manifold_constrained_gaussian_process_inference_tpu_torch.inference import checkpoint as ck
from manifold_constrained_gaussian_process_inference_tpu_torch.inference import (
    nuts_batched as nb,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.inference import solve as tsolve
from manifold_constrained_gaussian_process_inference_tpu_torch.ops import leaf as leaf_ops
from manifold_constrained_gaussian_process_inference_tpu_torch.inference.nuts import (
    MAX_DELTA_ENERGY,
    DenseMetric,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.inference.target import (
    MagiTarget as TTarget,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.inference.whiten import (
    PsiWhitener,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.ops.gp_cov import GPCov
from manifold_constrained_gaussian_process_inference_tpu_torch.parallel import chains as tc

torch.set_num_threads(1)
FOLD_RTOL = 1e-12
PROBE_RTOL = 1e-10


def _spd(dim, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((dim, dim))
    return scale * (a @ a.T / dim + np.eye(dim))


def _unit(dim, seed):
    v = np.random.default_rng(seed).standard_normal(dim)
    return v / np.linalg.norm(v)


# (cov, probes, envelope options): the SPD cases of tests/test_envelope.py
# (dominating, dominated, indefinite, capped), two probes folded in turn,
# and one probe boosting more directions than max_boost_dims, all distinct
FOLD_CASES = {
    "dominates_both": lambda: (_spd(8, 1), [np.linalg.inv(_spd(8, 1))
                                            + 80.0 * np.outer(_unit(8, 2), _unit(8, 2))], {}),
    "dominated_noop": lambda: (_spd(5, 3), [0.5 * np.linalg.inv(_spd(5, 3))], {}),
    "indefinite": lambda: (_spd(4, 4), [np.diag([500.0, -300.0, 0.0, 0.1])], {}),
    "lam_cap": lambda: (np.eye(3), [np.diag([1e12, 1.0, 1.0])], dict(lam_cap=100.0)),
    "two_probes": lambda: (_spd(6, 5), [_spd(6, 6, 40.0), np.diag(np.arange(1.0, 7.0) ** 3)], {}),
    "more_than_max_dims": lambda: (np.eye(40), [np.diag(np.linspace(2.0, 40.0, 40))], {}),
}


@pytest.mark.parametrize("case", sorted(FOLD_CASES))
def test_fold_matches_jax(case):
    cov, probes, options = FOLD_CASES[case]()
    envs = [cls(hess_fn=None, **options) for cls in (jc.CurvatureEnvelope, tc.CurvatureEnvelope)]
    for env in envs:
        for prec in probes:
            env.points.append(np.zeros(cov.shape[0]))
            env.precs.append(prec)
    want, got = (env.fold(cov) for env in envs)
    np.testing.assert_allclose(got, want, rtol=FOLD_RTOL, atol=0)
    assert (envs[1].boost_dirs, envs[1].boost_max) == (envs[0].boost_dirs, envs[0].boost_max)
    assert envs[1].boost_dirs <= envs[1].max_boost_dims * len(probes)
    if envs[1].boost_dirs == 0:
        assert got is cov
    else:  # the enveloped precision dominates the pooled one and each probe
        p_env = np.linalg.inv(got)
        assert np.linalg.eigvalsh(p_env - np.linalg.inv(cov)).min() > -1e-9


def test_empty_envelope_is_identity():
    cov = _spd(6, 5)
    assert tc.CurvatureEnvelope(hess_fn=None).fold(cov) is cov


def test_fold_keeps_max_boost_dims_when_boosts_tie_at_the_cap():
    """Where the capped boosts tie, the JAX package's ``>=`` on the k-th
    largest keeps every tie (here all 30 directions); the port keeps
    exactly max_boost_dims (ROADMAP Queue 3)."""
    cov, probe = np.eye(30), np.diag(np.full(30, 1e6))
    envs = [cls(hess_fn=None) for cls in (jc.CurvatureEnvelope, tc.CurvatureEnvelope)]
    for env in envs:
        env.points.append(np.zeros(30))
        env.precs.append(probe)
        env.fold(cov)
    assert envs[0].boost_dirs == 30
    assert envs[1].boost_dirs == envs[1].max_boost_dims == 16
    assert envs[1].boost_max == envs[0].boost_max == 1e4


def _both_collect(calls, **options):
    """Feed the same collect calls to both classes, each with a Hessian
    that records where it was asked; returns the two envelopes and their
    probe positions."""
    out = []
    for cls in (jc.CurvatureEnvelope, tc.CurvatureEnvelope):
        asked = []

        def hess(z, asked=asked):
            asked.append(np.array(z))
            return _spd(len(z), len(asked))

        env = cls(hess_fn=hess, **options)
        for args in calls:
            env.collect(*args)
        out.append((env, asked))
    return out


def test_collect_gates_and_picks_the_same_chain_and_point():
    """The gates of tests/test_envelope.py (before the first window, a
    clean chunk, mass divergence, max_points) and, on random chunks, the
    same chain, the same bisected point and the same precision as the JAX
    package."""
    rng = np.random.default_rng(0)
    c, dim = 6, 3
    calls = []
    for i in range(12):
        q_ld = rng.normal(size=(c, 2, dim))
        div = rng.uniform(size=(c, 40)) < (0.02 if i % 3 else 0.3)
        calls.append((q_ld, div.any(axis=1), div, i > 1))
    calls.append((np.zeros((c, 2, dim)), np.zeros(c, bool), np.zeros((c, 40), bool), True))

    def logp(z):
        return -0.5 * float(z @ z) - 1000.0 * max(float(z[0]) - 1.0, 0.0)

    (je, jz), (te, tz) = _both_collect(calls, logp_fn=logp, max_points=3)
    assert 1 <= len(te.points) == len(je.points) <= 3
    assert len(tz) == len(jz)
    for a, b in zip(te.points + te.precs + tz, je.points + je.precs + jz):
        np.testing.assert_array_equal(a, b)
    # max_points caps the probes
    (je, _), (te, _) = _both_collect([calls[2]] * 5, max_points=2)
    assert len(te.points) == len(je.points) == 2


def test_probe_point_bisection_matches_jax():
    def logp(z):
        return -0.5 * z[0] ** 2 - 1000.0 * max(float(z[0]) - 3.0, 0.0)

    edge = np.array([1.0])
    for leaf in (np.array([33.0]), np.array([np.nan]), np.array([1e30])):
        want = jc.CurvatureEnvelope(None, logp_fn=logp)._probe_point(edge, leaf)
        got = tc.CurvatureEnvelope(None, logp_fn=logp)._probe_point(edge, leaf)
        np.testing.assert_array_equal(got, want)
        assert np.all(np.isfinite(got))
    assert 1.0 < tc.CurvatureEnvelope(None, logp_fn=logp)._probe_point(edge, edge + 32)[0] <= 3.1
    assert tc.CurvatureEnvelope(None)._probe_point(edge, np.array([33.0]))[0] == 1.0


def test_last_div_position_is_exact():
    rng = np.random.default_rng(1)
    qs = rng.normal(size=(5, 7, 4))
    div = rng.uniform(size=(5, 7)) < 0.3
    div[2] = False
    q_j, has_j = jc._last_div_position(jnp.asarray(qs), jnp.asarray(div))
    q_t, has_t = tc._last_div_position(torch.as_tensor(qs), torch.as_tensor(div))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(has_t.numpy(), np.asarray(has_j))


def test_envelope_state_round_trips_through_a_warmup_checkpoint(tmp_path):
    env = tc.CurvatureEnvelope(hess_fn=None)
    rng = np.random.default_rng(0)
    for i in range(2):
        env.points.append(rng.standard_normal(3))
        env.precs.append(_spd(3, i))
    state, _ = ck.generator_state(torch.Generator().manual_seed(0))
    path = str(tmp_path / "wu.npz")
    ck.save_checkpoint(path, ck.SamplerCheckpoint(
        psi=np.zeros((2, 3)), step_size=np.zeros(0), inv_mass=np.eye(3), rng_state=state,
        rng_device="cpu", phase="warmup",
        warmup={"pos": 100, "carry": {n: np.zeros(2) for n in ck.WARMUP_CARRY_FIELDS},
                "metric_minv": np.eye(3), "metric_chol": np.eye(3), "metric_pchol": np.eye(3),
                "moments": [], "div": np.zeros((2, 0), bool), "envelope": env.state()},
    ))
    back = tc.CurvatureEnvelope(hess_fn=None)
    back.restore(ck.load_checkpoint(path).warmup["envelope"])
    for a, b in zip(env.points + env.precs, back.points + back.precs):
        np.testing.assert_array_equal(a, b)
    # and the JAX package reads the same keys
    jback = jc.CurvatureEnvelope(hess_fn=None)
    with np.load(path) as z:
        keys = sorted(k for k in z.files if k.startswith("wu_env_"))
    assert keys == ["wu_env_prec_000", "wu_env_prec_001", "wu_env_pt_000", "wu_env_pt_001"]
    del jback


# -- the probes of solve_magi against the JAX package's wiring ----------------


@pytest.fixture(scope="module")
def fn41():
    """A whitened FN target at n = 41 in both packages (float64, host)."""
    rng = np.random.default_rng(0)
    n = 41
    t = np.linspace(0, 8, n)
    y = np.stack([np.sin(t), np.cos(t)], -1) + 0.2 * rng.normal(size=(n, 2))
    cov_j = jm.build_gp_cov("matern52", np.array([[1.5, 1.5], [1.2, 1.2]]), t, bandsize=20)
    kw = dict(sigma_init=np.array([0.2, 0.2]), prior_temperature=(1.0, 1.0, 1.0),
              sigma_is_fixed=False)
    tj = JTarget.build(y, cov_j, J_FN, **kw)
    tt = TTarget.build(y, GPCov.from_numpy(cov_j), mt.FN_SYSTEM, **kw)
    dim = tt.dimension
    psi_c = np.concatenate([y.T.reshape(-1), [0.2, 0.2, 3.0], np.log([0.2, 0.2])])
    a = rng.normal(size=(dim, dim)) / np.sqrt(dim)
    w = 0.05 * (np.eye(dim) + 0.1 * a)
    return dict(tj=tj, tt=tt, w=w, c=psi_c, z=0.3 * rng.normal(size=dim))


def test_envelope_probes_match_the_jax_wiring(fn41):
    """hess_z and logp_z of solve_magi against the JAX package's solve.py
    wiring (its make_exact_hessian_fn and logdensity on the float64 host
    target, conjugated through the whitener)."""
    p = fn41
    whitener = PsiWhitener.from_numpy(p["w"], np.eye(len(p["c"])), p["c"])
    hess_z, logp_z = tsolve.envelope_probes(p["tt"], whitener)
    hess_psi = jw.make_exact_hessian_fn(p["tj"])
    psi = p["c"] + p["w"] @ p["z"]
    h = np.asarray(hess_psi(psi))
    pz = p["w"].T @ (-0.5 * (h + h.T)) @ p["w"]
    want_h = 0.5 * (pz + pz.T)
    want_lp = float(p["tj"].logdensity_fn()(jnp.asarray(psi)))
    np.testing.assert_allclose(hess_z(p["z"]), want_h, rtol=PROBE_RTOL,
                               atol=PROBE_RTOL * np.abs(want_h).max())
    np.testing.assert_allclose(logp_z(p["z"]), want_lp, rtol=PROBE_RTOL)


# -- divergent-leaf tracking ---------------------------------------------------


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


# The aten operations of one transition of _gauss_transition() without
# tracking, recorded on the tree whose state is updated in place, whose
# commits drift the next leaf and whose doublings open and merge through the
# plain versions of their kernels (its tracking code all sits behind the
# option).
UNTRACKED_OPS, UNTRACKED_DIGEST = 882, "4fadc76ad4920f17"


def _gauss_transition(**kw):
    C, dim = 4, 3
    scale = torch.tensor([1.0, 3.0, 0.3], dtype=torch.float64)

    def vg(q):
        g = -q * scale
        return -0.5 * (q * g * -1).sum(-1) * 1.0, g

    q = torch.as_tensor(np.random.default_rng(0).normal(size=(C, dim)))
    lp, g = vg(q)
    eye = torch.eye(dim, dtype=torch.float64)
    with _OpLog() as log:
        out = nb.nuts_transition_batched(vg, q, lp, g, 0.9, DenseMetric(eye, eye, eye),
                                         torch.Generator().manual_seed(3), max_depth=6, **kw)
    return log.ops, out


def test_untracked_transition_issues_the_same_operations():
    """Without tracking the transition issues exactly the operations it
    issued before the option existed; tracking adds its masked copies."""
    ops, _ = _gauss_transition()
    assert (len(ops), hashlib.sha256("\n".join(ops).encode()).hexdigest()[:16]) == \
        (UNTRACKED_OPS, UNTRACKED_DIGEST)
    tracked, _ = _gauss_transition(track_div_leaf=True)
    assert len(tracked) > len(ops)


def _pocket(curv=1000.0, edge=1.2, width=0.4):
    """tests/test_envelope.py's pocket target: z1 ~ N(0, 1) and z2 | z1 ~
    N(0, 1/g(z1)), g rising from 1 to ~curv past z1 = edge."""

    def logp(z):
        g = 1.0 + (curv - 1.0) * torch.sigmoid((z[..., 0] - edge) / width)
        return -0.5 * z[..., 0] ** 2 - 0.5 * g * z[..., 1] ** 2 + 0.5 * torch.log(g)

    def vg(q):
        q = q.detach().requires_grad_(True)
        with torch.enable_grad():
            lp = logp(q)
            (g,) = torch.autograd.grad(lp.sum(), q)
        return lp.detach(), g

    return logp, vg


def test_tracking_keeps_the_draws_and_records_the_divergent_step(monkeypatch):
    """Tracking on gives the draws of tracking off, bit for bit; the
    tracked leaf's energy error exceeds MAX_DELTA_ENERGY, its edge's does
    not. The energies come from a log of every leaf's log-density and
    kinetic term (the value-and-grad, then the kinetic dot product, per
    leaf)."""
    _, vg = _pocket()
    events = []
    real_dot = leaf_ops.rowdot  # the tree's row dots: the start energy's and each leaf's

    def vg_logged(q):
        lp, g = vg(q)
        events.append(("vg", q.clone(), lp.clone()))
        return lp, g

    def dot_logged(a, b):
        out = real_dot(a, b)
        events.append(("dot", out.clone()))
        return out

    q = torch.as_tensor(np.array([[1.5, 0.3], [0.0, 0.1], [2.0, -0.2], [1.0, 0.0]]))
    eye = torch.eye(2, dtype=torch.float64)
    metric = DenseMetric(eye, eye, eye)
    runs = {}
    for track in (False, True):
        q_cur, (lp, g) = q, vg(q)
        gen = torch.Generator().manual_seed(11)
        outs = []
        for _ in range(6):
            out = nb.nuts_transition_batched(vg, q_cur, lp, g, 0.5, metric, gen, max_depth=6,
                                             track_div_leaf=track)
            outs.append(out)
            q_cur, lp, g = out[0], out[1], out[2]
        runs[track] = outs
    for plain, tracked in zip(runs[False], runs[True]):
        for a, b in zip(plain[:3], tracked[:3]):
            assert torch.equal(a, b)
        assert torch.equal(plain[3].diverging, tracked[3].diverging)
    assert any(bool(out[3].diverging.any()) for out in runs[True])

    # one tracked transition with the energies logged
    monkeypatch.setattr(leaf_ops, "rowdot", dot_logged)
    lp, g = vg(q)
    q_n, lp_n, _, stats, (edge, leaf) = nb.nuts_transition_batched(
        vg_logged, q, lp, g, 0.5, metric, torch.Generator().manual_seed(11), max_depth=6,
        track_div_leaf=True)
    assert bool(stats.diverging.any())
    h0 = -lp + 0.5 * events[0][1]  # the first dot is the start momentum's
    energy = [(ev[1], -ev[2] + 0.5 * nxt[1]) for ev, nxt in zip(events, events[1:])
              if ev[0] == "vg" and nxt[0] == "dot"]
    for c in torch.nonzero(stats.diverging).flatten().tolist():
        at_leaf = [h[c] for qq, h in energy if torch.equal(qq[c], leaf[c])]
        assert at_leaf and float(at_leaf[0] - h0[c]) > MAX_DELTA_ENERGY
        at_edge = [h[c] for qq, h in energy if torch.equal(qq[c], edge[c])]
        if torch.equal(edge[c], q[c]):  # the transition's start: delta 0
            at_edge.append(h0[c])
        assert at_edge and all(float(h - h0[c]) <= MAX_DELTA_ENERGY for h in at_edge)
    for c in torch.nonzero(~stats.diverging).flatten().tolist():
        assert not edge[c].any() and not leaf[c].any()


# -- envelope runs ---------------------------------------------------------------


def test_envelope_inactive_is_bitwise_noop():
    """On a clean target the envelope collects nothing and the run equals
    envelope=None bit for bit (tests/test_envelope.py's regression guard)."""

    def fail(z):  # pragma: no cover - must never be called
        raise AssertionError("hess_fn called on a divergence-free run")

    def vg(q):
        return -0.5 * (q * q).sum(-1), -q

    kw = dict(n_samples=300, n_adapts=150, initial_step_size=0.3, mass_matrix="dense-pooled")
    psi0 = torch.zeros((4, 3), dtype=torch.float64)
    s_plain, i_plain = tc.run_chains(vg, psi0, torch.Generator().manual_seed(3), **kw)
    s_env, info = tc.run_chains(vg, psi0, torch.Generator().manual_seed(3),
                                envelope=tc.CurvatureEnvelope(fail), **kw)
    np.testing.assert_array_equal(s_plain, s_env)
    np.testing.assert_array_equal(i_plain["inv_mass"], info["inv_mass"])
    assert (info["envelope_points"], info["envelope_boost_dirs"]) == (0, 0)
    assert "envelope_points" not in i_plain


def _fn9():
    """The small FN problem of tests/test_torch_checkpoint.py (n = 9,
    sigma and phi fixed)."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.utils.integrators import (
        integrate_system,
        sample_on_grid,
    )

    rng = np.random.default_rng(0)
    ts, xs = integrate_system(mt.FN_SYSTEM, [-1.0, 1.0], 0.0, 4.0, np.array([0.2, 0.2, 3.0]), 400)
    t = np.linspace(0.0, 4.0, 9)
    y = sample_on_grid(ts.numpy(), xs.numpy(), t) + 0.1 * rng.normal(size=(9, 2))
    return y, t, dict(niter_hmc=40, seed=3, sigma=[0.1, 0.1], phi=np.array([[1.0, 1.0],
                                                                            [1.5, 1.5]]),
                      device="cpu", n_chains=4)


@pytest.mark.parametrize("options,enabled,warns", [
    (dict(mass_matrix="dense-pooled", x_whitened=True), True, False),
    (dict(mass_matrix="diag", x_whitened=True), False, True),
    (dict(mass_matrix="dense-pooled", x_whitened=False), False, True),
    (dict(sampler="chees", mass_matrix="dense-pooled", x_whitened=True), False, False),
])
def test_solve_magi_divergence_envelope(options, enabled, warns, caplog):
    """solve_magi(divergence_envelope=True) returns the three envelope keys
    on the dense-pooled whitened NUTS path; it warns and disables the
    envelope for another metric or raw Psi, and leaves it off silently for
    the other samplers, as the JAX package does."""
    y, t, base = _fn9()
    config = mt.MagiConfig(**base, divergence_envelope=True, **options)
    with caplog.at_level(logging.WARNING):
        res = mt.solve_magi(y, t, mt.FN_SYSTEM, config)
    d = res.diagnostics
    keys = {"envelope_points", "envelope_boost_dirs", "envelope_boost_max"}
    if enabled:
        assert keys <= set(d)
        assert d["envelope_points"] >= 0 and d["envelope_boost_max"] >= 1.0
        assert d["envelope_boost_dirs"] <= 16 * d["envelope_points"]
    else:
        assert not keys & set(d)
    assert any("divergence_envelope requires" in r.message for r in caplog.records) == warns
    assert np.isfinite(res.theta).all()


def _pocket_run(envelope, seed, **kw):
    _, vg = _pocket()
    psi0 = torch.as_tensor(0.1 * np.random.default_rng(0).standard_normal((8, 2)))
    return tc.run_chains(vg, psi0, torch.Generator().manual_seed(seed), initial_step_size=0.2,
                         mass_matrix="dense-pooled", target_accept=0.8, envelope=envelope, **kw)


def _pocket_envelope():
    logp, _ = _pocket()
    return tc.CurvatureEnvelope(
        lambda z: -torch.func.hessian(logp)(torch.as_tensor(z)).numpy(),
        logp_fn=lambda z: float(logp(torch.as_tensor(z))), max_div_frac=0.5)


def test_warmup_checkpoint_with_probes_resumes_bit_equal(tmp_path, monkeypatch):
    """A pooled warmup killed after the envelope probed resumes from its
    checkpoint, with a fresh envelope, to the uninterrupted run's draws,
    metric and envelope readings, bit for bit."""
    kept = {}
    real = ck.save_checkpoint

    def capture(path, ckpt):
        env = ckpt.warmup and ckpt.warmup["envelope"]
        if "path" not in kept and env and env["points"] and ckpt.warmup["pos"] < 200:
            kept["path"] = str(tmp_path / "kept.npz")
            real(kept["path"], ckpt)
        real(path, ckpt)

    monkeypatch.setattr(ck, "save_checkpoint", capture)
    kw = dict(n_samples=210, n_adapts=200, chunk_size=25,
              checkpoint_path=str(tmp_path / "ckpt.npz"))
    full, info = _pocket_run(_pocket_envelope(), 1, **kw)
    assert "path" in kept, "no warmup checkpoint after a probe"
    mid = ck.load_checkpoint(kept["path"])
    assert 1 <= len(mid.warmup["envelope"]["points"]) <= info["envelope_points"]
    resumed, info_r = _pocket_run(_pocket_envelope(), 1, resume_ckpt=mid, **kw)
    np.testing.assert_array_equal(resumed, full)
    np.testing.assert_array_equal(info_r["inv_mass"], info["inv_mass"])
    for key in ("envelope_points", "envelope_boost_dirs", "envelope_boost_max"):
        assert info_r[key] == info[key]
    assert info["envelope_points"] >= 1 and info["envelope_boost_dirs"] >= 1


def test_jax_warmup_checkpoint_with_probes_converts(tmp_path):
    """A JAX package warmup checkpoint (its carry by pytree leaf, the
    envelope's probes under wu_env_*) converts through from_jax_checkpoint:
    the carry by field name, the metric, moments and probes unchanged; the
    port's warmup resumes from it and folds the carried probes."""
    dim, c = 2, 4
    q0 = np.random.default_rng(2).normal(size=(c, dim))
    vg_j = jax.vmap(jax.value_and_grad(lambda q: -0.5 * jnp.sum(q * q)))
    carry = jnb.init_warmup_carry_batched(vg_j, jnp.asarray(q0),
                                          jax.random.split(jax.random.PRNGKey(0), c), 0.3)
    env = jc.CurvatureEnvelope(hess_fn=None)
    env.points.append(np.full(dim, 0.5))
    env.precs.append(np.diag([400.0, 1.0]))
    cov = np.diag([1.2, 0.8])
    chol = np.linalg.cholesky(cov)
    path = str(tmp_path / "jax_wu.npz")
    jck.save_checkpoint(path, jck.SamplerCheckpoint(
        psi=q0, step_size=np.zeros(0), inv_mass=cov, key=np.asarray(carry.chain.key),
        meta={"metric": "dense-pooled", "step_jitter": 0.0, "step_jitter_low": 0.4,
              "n_adapts": 200, "chunk_size": 1000},
        phase="warmup",
        warmup={"pos": 100,
                "carry_leaves": [np.asarray(a) for a in jax.tree_util.tree_leaves(carry)],
                "metric_minv": cov, "metric_chol": chol, "metric_pchol": np.linalg.inv(chol).T,
                "moments": [(np.asarray(10.0), np.ones(dim), np.eye(dim) * 12.0,
                             np.asarray(12.0), np.asarray(2.0))],
                "div": np.zeros((c, 100), bool), "envelope": env.state()},
    ))
    port = ck.from_jax_checkpoint(jck.load_checkpoint(path), seed=5)
    w = port.warmup
    assert port.phase == "warmup" and w["pos"] == 100
    for name, want in (("q", carry.chain.q), ("logp", carry.chain.logp), ("grad", carry.chain.grad),
                       *((f, getattr(carry.da, f)) for f in carry.da._fields)):
        np.testing.assert_array_equal(w["carry"][name], np.asarray(want))
    assert sorted(w["carry"]) == sorted(ck.WARMUP_CARRY_FIELDS)
    for a, b in zip(w["envelope"]["points"] + w["envelope"]["precs"], env.points + env.precs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(w["metric_chol"], chol)
    resumed_env = tc.CurvatureEnvelope(hess_fn=None)
    samples, info = tc.run_chains(lambda q: (-0.5 * (q * q).sum(-1), -q),
                                  torch.as_tensor(q0), torch.Generator(), n_samples=240,
                                  n_adapts=200, mass_matrix="dense-pooled", resume_ckpt=port,
                                  envelope=resumed_env)
    assert samples.shape == (c, 40, dim) and np.isfinite(samples).all()
    assert info["envelope_points"] == 1 and info["envelope_boost_dirs"] >= 1


# The pocket reproducer's seed. Its bars are seed-sensitive in both
# packages: over generator seeds 0-7 the port met all of
# them at 1, 2, 3, 5 and 6; the JAX package's own run_chains, over PRNG
# keys 0-5 and 7, at 1, 2 and 7 (its test's key).
POCKET_SEED = 1


def test_envelope_tames_pocket_divergences():
    """tests/test_envelope.py's pocket reproducer under the JAX package's
    bars: the plain run diverges (>= 15), the envelope cuts the divergences
    at least five-fold, the adapted step size rises more than 1.5x (the
    pocket stops taxing the bulk), and the draws keep z1 ~ N(0, 1) with the
    pocket's mass (true P(z1 > 1.2) = 0.115)."""
    kw = dict(n_samples=900, n_adapts=500)
    _, info_plain = _pocket_run(None, POCKET_SEED, **kw)
    s_env, info_env = _pocket_run(_pocket_envelope(), POCKET_SEED, **kw)
    div_plain = int(np.sum(info_plain["diverging"]))
    div_env = int(np.sum(info_env["diverging"]))
    assert div_plain >= 15, div_plain
    assert div_env <= div_plain // 5, (div_plain, div_env)
    assert info_env["envelope_points"] >= 1 and info_env["envelope_boost_dirs"] >= 1
    assert float(np.mean(info_env["step_size"])) > 1.5 * float(np.mean(info_plain["step_size"]))
    flat = s_env.reshape(-1, 2)
    assert np.all(np.isfinite(flat))
    assert abs(float(flat[:, 0].mean())) < 0.2
    assert abs(float(flat[:, 0].std()) - 1.0) < 0.15
    occ = float((flat[:, 0] > 1.2).mean())
    assert 0.05 < occ < 0.2, occ
