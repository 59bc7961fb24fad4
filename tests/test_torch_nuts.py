"""PyTorch port, NUTS and the chain driver: the window schedule, dual
averaging, Welford moments, checkpoint indices, chunking, step jitter and
the pooled dense metric equal the JAX package's; the batched transition
matches the JAX transitions' tree sizes under a dense and a diagonal
metric, its dense path is bit-identical to the parent commit's, and the
single-chain API (run_nuts, the diag Welford warmup) and the diag driver
recover Gaussian moments and return the JAX package's info keys."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manifold_constrained_gaussian_process_inference_tpu.inference import adapt as ja
from manifold_constrained_gaussian_process_inference_tpu.inference import nuts as jn
from manifold_constrained_gaussian_process_inference_tpu.inference import nuts_batched as jb
from manifold_constrained_gaussian_process_inference_tpu.parallel import chains as jc
from manifold_constrained_gaussian_process_inference_tpu_torch.inference import adapt as ta
from manifold_constrained_gaussian_process_inference_tpu_torch.inference import nuts as tn
from manifold_constrained_gaussian_process_inference_tpu_torch.inference import (
    nuts_batched as tb,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.parallel import chains as tc

torch.set_num_threads(1)


@pytest.mark.parametrize("n_adapts", [0, 10, 100, 149, 150, 500, 1500])
def test_window_schedule_matches_jax(n_adapts):
    for got, want in zip(ta.build_window_schedule(n_adapts), ja.build_window_schedule(n_adapts)):
        np.testing.assert_array_equal(got, want)
    _, window_end = ta.build_window_schedule(n_adapts)
    assert tc._window_aligned_chunks(window_end, 40) == jc._window_aligned_chunks(window_end, 40)
    assert tc._chunk_lengths(n_adapts, 40) == jc._chunk_lengths(n_adapts, 40)


def test_dual_averaging_matches_jax():
    rng = np.random.default_rng(0)
    eps0 = np.array([0.06, 0.3, 1.0])
    st_t, st_j = ta.da_init(torch.as_tensor(eps0)), ja.da_init(jnp.asarray(eps0))
    for step in range(60):
        acc = rng.uniform(size=3)
        st_t = ta.da_update(st_t, torch.as_tensor(acc), 0.95)
        st_j = ja.da_update(st_j, jnp.asarray(acc), 0.95)
        if step == 30:
            st_t, st_j = ta.da_restart(st_t), ja.da_restart(st_j)
        for got, want in zip(st_t, st_j):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13)


def test_welford_matches_jax():
    xs = np.random.default_rng(1).normal(size=(40, 6))
    st_t, st_j = ta.welford_init(6, torch.float64), ja.welford_init(6, jnp.float64)
    for x in xs:
        st_t, st_j = ta.welford_update(st_t, torch.as_tensor(x)), ja.welford_update(st_j, jnp.asarray(x))
    np.testing.assert_allclose(
        ta.welford_variance_regularized(st_t).numpy(),
        np.asarray(ja.welford_variance_regularized(st_j)), rtol=1e-13,
    )


def test_checkpoint_index_helpers_match_jax():
    for n in range(2048):
        assert tn._popcount32(n) == int(jn._popcount32(jnp.int32(n)))
        lo, hi = jn._leaf_idx_to_ckpt_idxs(jnp.int32(n))
        assert tn._leaf_idx_to_ckpt_idxs(n) == (int(lo), int(hi))


def test_jitter_multipliers_match_jax():
    got = tc.jitter_multipliers(np.random.default_rng(5), 500, 0.125, 0.4)
    want = jc.jitter_multipliers(np.random.default_rng(5), 500, 0.125, 0.4, jnp.float64)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert np.all(tc.jitter_multipliers(np.random.default_rng(5), 50, 0.0, 0.4) == 1.0)


def _moments(dim, seed=0, n=5000):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(dim, dim))
    cov = a @ a.T / dim + np.eye(dim)
    qs = rng.multivariate_normal(np.zeros(dim), cov, size=(3, n // 3))
    div = rng.uniform(size=qs.shape[:2]) < 0.05
    w = (~div).astype(float)
    moments = (w.sum(), (qs * w[..., None]).sum((0, 1)),
               np.einsum("cld,cle->de", qs * w[..., None], qs), float(div.size),
               float(div.sum()))
    return qs, div, moments


def _metrics_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-12)


def _identity(dim):
    eye = np.eye(dim)
    return (tn.DenseMetric(*(torch.as_tensor(eye) for _ in range(3))),
            jn.DenseMetric(*(jnp.asarray(eye) for _ in range(3))))


def test_pooled_metric_from_moments_matches_jax():
    dim = 12
    _, _, m = _moments(dim)
    prev_t, prev_j = _identity(dim)
    half = [tuple(np.asarray(x) / 2 for x in m)] * 2
    got = tc.pooled_dense_metric_from_moments(half, dim, torch.float64, prev_t)
    want = jc.pooled_dense_metric_from_moments(half, dim, jnp.float64, prev_j)
    _metrics_equal(got, want)
    # policies: mostly divergent window, and a window that barely moved
    bad = [(m[0], m[1], m[2], 100.0, 60.0)]
    assert tc.pooled_dense_metric_from_moments(bad, dim, torch.float64, prev_t) is prev_t
    frozen = [(m[0], m[1] * 0, m[2] * 1e-6, m[3], 0.0)]
    assert tc.pooled_dense_metric_from_moments(frozen, dim, torch.float64, prev_t) is prev_t


def test_pooled_metric_from_draws_matches_jax():
    dim = 8
    qs, div, _ = _moments(dim, seed=3, n=600)
    mask = [np.ones(qs.shape[1], dtype=bool)]
    prev_t, prev_j = _identity(dim)
    for window_div in (None, [div]):
        got = tc._pooled_dense_metric([qs], mask, dim, torch.float64, prev_t, window_div)
        want = jc._pooled_dense_metric([qs], mask, dim, jnp.float64, prev_j, window_div)
        _metrics_equal(got, want)


SCALES = np.linspace(0.5, 2.0, 20)


def _vg_t(q):
    s = torch.as_tensor(SCALES, dtype=q.dtype)
    return -0.5 * ((q / s) ** 2).sum(-1), -q / s**2


def test_tree_sizes_match_jax_transition():
    """Same target, step size and metric: the per-chain leapfrog counts of
    the two batched transitions agree in distribution (the random streams
    differ), and so do the draws' scales."""
    C, dim, eps = 64, SCALES.shape[0], 0.25
    metric_t, metric_j = _identity(dim)
    q0 = np.random.default_rng(0).normal(size=(C, dim)) * SCALES
    q = torch.as_tensor(q0)
    lp, g = _vg_t(q)
    gen = torch.Generator().manual_seed(0)
    vg_j = jax.vmap(lambda x: (-0.5 * jnp.sum((x / SCALES) ** 2), -x / SCALES**2))
    step_j = jax.jit(lambda q, lp, g, k: jb.nuts_transition_batched(vg_j, q, lp, g, k, eps, metric_j))
    qj = jnp.asarray(q0)
    lpj, gj = vg_j(qj)
    keys = jax.random.split(jax.random.PRNGKey(0), C)
    n_t, n_j, d_t, d_j = [], [], [], []
    for _ in range(40):
        q, lp, g, st = tb.nuts_transition_batched(_vg_t, q, lp, g, eps, metric_t, gen)
        ks = jax.vmap(jax.random.split)(keys)
        keys = ks[:, 0]
        qj, lpj, gj, stj = step_j(qj, lpj, gj, ks[:, 1])
        n_t.append(st.num_leapfrog.numpy())
        n_j.append(np.asarray(stj.num_leapfrog))
        d_t.append(q.numpy())
        d_j.append(np.asarray(qj))
        assert st.lockstep_leaves >= int(st.num_leapfrog.max())
    assert abs(np.mean(n_t) / np.mean(n_j) - 1.0) < 0.1
    sd_t, sd_j = np.std(np.concatenate(d_t[5:]), 0), np.std(np.concatenate(d_j[5:]), 0)
    np.testing.assert_allclose(sd_t / SCALES, 1.0, atol=0.15)
    np.testing.assert_allclose(sd_j / SCALES, 1.0, atol=0.15)


def test_std_normal_moments_under_pooled_driver():
    dim, C = 6, 16
    vg = lambda q: (-0.5 * (q * q).sum(-1), -q)
    psi0 = torch.as_tensor(np.random.default_rng(1).normal(size=(C, dim)))
    samples, info = tc.run_chains(
        vg, psi0, torch.Generator().manual_seed(1), n_samples=500, n_adapts=250,
        initial_step_size=0.5, target_accept=0.8, chunk_size=100,
    )
    flat = samples.reshape(-1, dim)
    assert samples.shape == (C, 250, dim)
    np.testing.assert_allclose(flat.mean(0), 0.0, atol=0.1)
    np.testing.assert_allclose(flat.var(0), 1.0, atol=0.15)
    assert info["lp"].shape == (C, 250) and info["step_size"].shape == (C,)
    assert info["host_syncs"] > 0 and info["lockstep_leaves"] >= info["transitions"]


def test_correlated_gaussian_pooled_metric_learns_covariance():
    dim, C, rho = 4, 16, 0.9
    cov = rho * np.ones((dim, dim)) + (1 - rho) * np.eye(dim)
    prec = torch.as_tensor(np.linalg.inv(cov))

    def vg(q):
        g = -q @ prec
        return 0.5 * (g * q).sum(-1), g

    psi0 = torch.as_tensor(np.random.default_rng(2).normal(size=(C, dim)))
    samples, info = tc.run_chains(
        vg, psi0, torch.Generator().manual_seed(2), n_samples=600, n_adapts=300,
        initial_step_size=0.3, target_accept=0.8, chunk_size=100,
        step_jitter=0.125, jitter_rng=np.random.default_rng(0),
    )
    np.testing.assert_allclose(np.cov(samples.reshape(-1, dim), rowvar=False), cov, atol=0.15)
    # the pooled metric has learned the correlation
    assert np.min(info["inv_mass"][~np.eye(dim, dtype=bool)]) > 0.5


def test_divergences_reject_instead_of_raising():
    def vg(q):  # a cliff: non-finite density beyond q0 > 1.5
        lp = -0.5 * (q * q).sum(-1)
        lp = torch.where(q[:, 0] > 1.5, torch.full_like(lp, float("nan")), lp)
        return lp, -q

    C, dim = 8, 3
    metric, _ = _identity(dim)
    q = torch.zeros((C, dim), dtype=torch.float64)
    lp, g = vg(q)
    gen = torch.Generator().manual_seed(3)
    n_div = 0
    for _ in range(30):
        q, lp, g, st = tb.nuts_transition_batched(vg, q, lp, g, 1.0, metric, gen)
        n_div += int(st.diverging.sum())
        assert torch.isfinite(lp).all() and bool((q[:, 0] <= 1.5).all())
    assert n_div > 0


# The dense-metric transition of the parent commit, recorded bit for bit
# (float.hex) on the target and metric of _dense_case: the metric types now
# carry momentum() and velocity(), and the dense path must not move. The
# last acceptance probability was recorded anew (5e-16 apart) when the
# per-chain dot products became elementwise sums, which round a chain
# alike at any batch size; the positions and tree sizes did not move.
DENSE_RECORDED_Q = [
    "-0x1.852ea5325c8a0p-3", "0x1.1a4e9e4adbd5cp-1", "0x1.3f2d104aafdcap+0",
    "0x1.2897663ab5ea2p+0", "0x1.76ad547b20d22p-1", "-0x1.bd1ae28abe66ep-1",
    "0x1.d39a283a9b0ffp-1", "-0x1.83f2b701d171ep+0", "-0x1.0ea93b110aae2p+0",
    "0x1.2870ac43409c4p+1", "0x1.23668fe604fa4p-3", "-0x1.9db1f6c856ff5p+0",
    "-0x1.4016de6d02fa2p-1", "-0x1.3d10de408d5afp+0", "-0x1.45dd58ac1586ap-1",
    "-0x1.43b40db722b09p+0", "0x1.e5c2737181d97p-2", "-0x1.ca9d802853122p+0",
    "0x1.1ea3e00750d46p+1", "-0x1.c09c9375fd86fp-3",
]
DENSE_RECORDED_LEAVES = [[7.0, 7.0, 7.0, 3.0], [15.0, 15.0, 15.0, 7.0], [7.0, 7.0, 7.0, 7.0]]
DENSE_RECORDED_ACCEPT = ["0x1.0000000000000p+0", "0x1.fdfd7311e3919p-1",
                         "0x1.e64a42906e299p-1", "0x1.e0a7fff30222fp-1"]


def _dense_case():
    rng = np.random.default_rng(11)
    dim, C = 5, 4
    a = rng.normal(size=(dim, dim))
    prec = torch.as_tensor(np.linalg.inv(a @ a.T / dim + np.eye(dim)))
    minv = rng.normal(size=(dim, dim))
    minv = minv @ minv.T / dim + np.eye(dim)
    chol = np.linalg.cholesky(minv)
    metric = tn.DenseMetric(*(torch.as_tensor(m) for m in (minv, chol, np.linalg.inv(chol).T)))

    def vg(q):
        g = -q @ prec
        return 0.5 * (g * q).sum(-1), g

    return vg, torch.as_tensor(rng.normal(size=(C, dim))), metric


def test_dense_path_bit_identical_to_before():
    vg, q, metric = _dense_case()
    lp, g = vg(q)
    gen = torch.Generator().manual_seed(11)
    leaves = []
    for _ in range(3):
        q, lp, g, st = tb.nuts_transition_batched(vg, q, lp, g, 0.4, metric, gen, max_depth=6)
        leaves.append(st.num_leapfrog.tolist())
    assert [x.hex() for x in q.numpy().ravel()] == DENSE_RECORDED_Q
    assert leaves == DENSE_RECORDED_LEAVES
    assert [x.hex() for x in st.accept_prob.numpy()] == DENSE_RECORDED_ACCEPT


def test_dense_identity_matches_diag_unit_bitwise():
    """The identity dense metric and the unit diagonal one give the same
    transition bit for bit from the same generator state."""
    vg, q0, _ = _dense_case()
    eye = torch.eye(q0.shape[1], dtype=q0.dtype)
    out = []
    for metric in (tn.DenseMetric(eye, eye, eye), tn.DiagMetric(torch.ones_like(q0))):
        q, (lp, g) = q0, vg(q0)
        gen = torch.Generator().manual_seed(3)
        for _ in range(4):
            q, lp, g, st = tb.nuts_transition_batched(vg, q, lp, g, 0.3, metric, gen)
        out.append((q, lp, st.num_leapfrog))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_diag_tree_sizes_match_jax_transition():
    """Same target, step size and diagonal metric: the per-chain leapfrog
    counts of the port's transition and of the JAX package's single-chain
    ``nuts_transition`` (vmapped) agree in distribution, and so do the
    draws' scales."""
    C, dim, eps = 64, SCALES.shape[0], 0.5
    inv_mass = SCALES**2 * np.exp(np.random.default_rng(2).uniform(-0.3, 0.3, size=dim))
    q0 = np.random.default_rng(0).normal(size=(C, dim)) * SCALES
    q = torch.as_tensor(q0)
    lp, g = _vg_t(q)
    metric = tn.DiagMetric(torch.as_tensor(np.tile(inv_mass, (C, 1))))
    gen = torch.Generator().manual_seed(0)
    vg_j = jax.value_and_grad(lambda x: -0.5 * jnp.sum((x / SCALES) ** 2))
    step_j = jax.jit(jax.vmap(lambda q, lp, g, k: jn.nuts_transition(
        vg_j, q, lp, g, k, jnp.asarray(eps), jnp.asarray(inv_mass))))
    qj = jnp.asarray(q0)
    lpj, gj = jax.vmap(vg_j)(qj)
    keys = jax.random.split(jax.random.PRNGKey(0), C)
    n_t, n_j, d_t, d_j = [], [], [], []
    for _ in range(40):
        q, lp, g, st = tb.nuts_transition_batched(_vg_t, q, lp, g, eps, metric, gen)
        ks = jax.vmap(jax.random.split)(keys)
        keys = ks[:, 0]
        qj, lpj, gj, stj = step_j(qj, lpj, gj, ks[:, 1])
        n_t.append(st.num_leapfrog.numpy())
        n_j.append(np.asarray(stj.num_leapfrog))
        d_t.append(q.numpy())
        d_j.append(np.asarray(qj))
    assert abs(np.mean(n_t) / np.mean(n_j) - 1.0) < 0.1
    sd_t, sd_j = np.std(np.concatenate(d_t[5:]), 0), np.std(np.concatenate(d_j[5:]), 0)
    np.testing.assert_allclose(sd_t / SCALES, 1.0, atol=0.15)
    np.testing.assert_allclose(sd_j / SCALES, 1.0, atol=0.15)


def test_single_chain_transition_is_the_batched_one_at_c1():
    vg1 = lambda q: (-0.5 * (q * q).sum(-1), -q)  # noqa: E731
    q = torch.linspace(-1.0, 1.0, 6, dtype=torch.float64)
    lp, g = vg1(q)
    inv_mass = torch.linspace(0.5, 2.0, 6, dtype=torch.float64)
    one = tn.nuts_transition(vg1, q, lp, g, torch.Generator().manual_seed(4), 0.4, inv_mass)
    batched = tb.nuts_transition_batched(vg1, q[None], lp[None], g[None], 0.4,
                                         tn.DiagMetric(inv_mass), torch.Generator().manual_seed(4))
    for a, b in zip(one[:3], batched[:3]):
        assert torch.equal(a, b[0])
    assert torch.equal(one[3].num_leapfrog, batched[3].num_leapfrog)


def test_warmup_step_adapts_inv_mass_at_window_end():
    """In-window draws join the per-chain Welford moments (working dtype);
    at the window end the inverse mass becomes Stan's regularized variance
    of those draws, and the moments and dual averaging restart."""
    vg = lambda q: (-0.5 * (q * q).sum(-1), -q)  # noqa: E731
    q0 = torch.as_tensor(np.random.default_rng(0).normal(size=(3, 4)))
    carry = tn.init_warmup_carry(vg, q0, 0.5)
    assert carry.welford.count.shape == (3,) and torch.equal(carry.inv_mass, torch.ones_like(q0))
    step = tn.make_warmup_step(vg, 0.8, 10, torch.Generator().manual_seed(0))
    draws = []
    for t in range(12):
        carry, _ = step(carry, t >= 2, t == 11)
        if t >= 2:
            draws.append(carry.chain.q.numpy())
    xs = np.stack(draws, axis=1)  # (C, 10, dim)
    w = 10 / 15
    want = w * xs.var(axis=1, ddof=1) + 1e-3 * (1 - w)
    np.testing.assert_allclose(carry.inv_mass.numpy(), want, rtol=1e-12)
    assert carry.welford.count.abs().sum() == 0 and carry.da.count.abs().sum() == 0
    assert carry.welford.mean.dtype == torch.float64


def test_std_normal_moments_under_run_nuts():
    """Mirror of the JAX package's test_std_normal_moments (run_nuts, diag
    warmup; 2,000 kept draws)."""
    vg = lambda q: (-0.5 * (q * q).sum(), -q)  # noqa: E731
    samples, info = tn.run_nuts(vg, torch.zeros(4, dtype=torch.float64),
                                torch.Generator().manual_seed(0), n_samples=2500, n_adapts=500)
    assert samples.shape == (2000, 4)
    assert np.abs(samples.mean(0)).max() < 0.15
    assert np.abs(samples.var(0) - 1.0).max() < 0.2
    assert 0.6 < float(np.mean(info["accept_prob"])) <= 1.0
    assert int(np.sum(info["diverging"])) == 0
    assert info["inv_mass"].shape == (4,) and np.ndim(info["step_size"]) == 0


def test_correlated_gaussian_moments_and_mass_adaptation_under_run_nuts():
    """Mirror of the JAX package's test of the same name (2,000 kept draws)."""
    d = 5
    rng = np.random.default_rng(1)
    a = rng.normal(size=(d, d))
    covm = a @ a.T + d * np.eye(d)
    prec = torch.as_tensor(np.linalg.inv(covm))
    mu = torch.arange(d, dtype=torch.float64)

    def vg(q):
        g = -prec @ (q - mu)
        return 0.5 * (q - mu) @ g, g

    samples, info = tn.run_nuts(vg, torch.zeros(d, dtype=torch.float64),
                                torch.Generator().manual_seed(3), n_samples=3000, n_adapts=1000)
    sd = np.sqrt(np.diag(covm))
    assert np.all(np.abs(samples.mean(0) - np.arange(d)) < 0.25 * sd)
    assert np.all(np.abs(samples.var(0) / np.diag(covm) - 1.0) < 0.35)
    ratio = info["inv_mass"] / np.diag(covm)
    assert np.all(ratio > 0.3) and np.all(ratio < 3.0)


def test_std_normal_moments_under_diag_driver():
    dim, C = 6, 8
    vg = lambda q: (-0.5 * (q * q).sum(-1), -q)  # noqa: E731
    psi0 = torch.as_tensor(np.random.default_rng(1).normal(size=(C, dim)))
    samples, info = tc.run_chains(
        vg, psi0, torch.Generator().manual_seed(1), n_samples=500, n_adapts=250,
        initial_step_size=0.5, target_accept=0.8, chunk_size=100, mass_matrix="diag",
    )
    flat = samples.reshape(-1, dim)
    assert samples.shape == (C, 250, dim) and info["metric"] == "diag"
    np.testing.assert_allclose(flat.mean(0), 0.0, atol=0.1)
    np.testing.assert_allclose(flat.var(0), 1.0, atol=0.15)
    assert info["inv_mass"].shape == (C, dim) and info["step_size"].shape == (C,)
    np.testing.assert_allclose(info["inv_mass"], 1.0, atol=0.5)
    assert info["warmup_diverging"].shape == (C, 250)


def test_correlated_gaussian_moments_and_mass_adaptation_under_diag_driver():
    """The run_nuts mirror above at C = 4 through run_chains: per-chain
    inverse masses near the marginal variances."""
    d, C = 5, 4
    rng = np.random.default_rng(1)
    a = rng.normal(size=(d, d))
    covm = a @ a.T + d * np.eye(d)
    prec = torch.as_tensor(np.linalg.inv(covm))
    mu = torch.arange(d, dtype=torch.float64)

    def vg(q):
        g = -(q - mu) @ prec
        return 0.5 * ((q - mu) * g).sum(-1), g

    samples, info = tc.run_chains(vg, torch.zeros((C, d), dtype=torch.float64),
                                  torch.Generator().manual_seed(3), n_samples=1200,
                                  n_adapts=600, mass_matrix="diag")
    flat = samples.reshape(-1, d)
    sd = np.sqrt(np.diag(covm))
    assert np.all(np.abs(flat.mean(0) - np.arange(d)) < 0.25 * sd)
    assert np.all(np.abs(flat.var(0) / np.diag(covm) - 1.0) < 0.35)
    ratio = info["inv_mass"] / np.diag(covm)
    assert np.all(ratio > 0.3) and np.all(ratio < 3.0)


def test_diag_driver_info_matches_jax():
    """run_chains(mass_matrix="diag"): every info key of the JAX package's,
    with the same shapes (``final_key`` is the state of the one torch
    generator, not C PRNG keys)."""
    C, dim = 3, 4
    q0 = np.random.default_rng(0).normal(size=(C, dim))
    _, want = jc.run_chains(
        jax.value_and_grad(lambda q: -0.5 * jnp.sum(q * q)), jnp.asarray(q0),
        jax.random.split(jax.random.PRNGKey(0), C), n_samples=20, n_adapts=10,
        chunk_size=8, mass_matrix="diag",
    )
    samples, got = tc.run_chains(lambda q: (-0.5 * (q * q).sum(-1), -q), torch.as_tensor(q0),
                                 torch.Generator().manual_seed(0), n_samples=20, n_adapts=10,
                                 chunk_size=8, mass_matrix="diag")
    assert samples.shape == (C, 10, dim)
    assert set(want) <= set(got)
    for key in set(want) - {"final_key"}:
        assert np.shape(got[key]) == np.shape(want[key]), key


@pytest.mark.parametrize("kw,error", [
    (dict(step_jitter=0.125), ValueError), (dict(envelope=object()), ValueError),
    (dict(resume_ckpt=object()), ValueError), (dict(mass_matrix="dense"), ValueError),
    (dict(mass_matrix="dense-pooled", envelope=object(), batched_transition=False), ValueError),
    (dict(mass_matrix="dense-pooled", resume_ckpt=object()), ValueError),
])
def test_driver_refuses_options_of_the_other_metric(kw, error):
    with pytest.raises(error):
        tc.run_chains(lambda q: (q.sum(-1), q), torch.zeros(2, 2), torch.Generator(),
                      n_samples=4, n_adapts=2, **{"mass_matrix": "diag", **kw})


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graphed_value_and_grad_replays_eager_results(cuda_device):
    """The CUDA-graph replay of a value-and-grad that runs the band kernel
    gives the eager results and counts the kernel launches it replays."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.ops import cuda_band

    rng = np.random.default_rng(0)
    bands = torch.as_tensor(rng.normal(size=(2, 9, 50)), device=cuda_device)
    bands_t = torch.as_tensor(rng.normal(size=(2, 9, 50)), device=cuda_device)

    def vg(q):
        q = q.detach().requires_grad_(True)
        with torch.enable_grad():
            y = cuda_band.band_matvec(bands, bands_t, q.reshape(-1, 2, 50), 4)
            lp = -0.5 * (y * y).sum((-2, -1))
            (g,) = torch.autograd.grad(lp.sum(), q)
        return lp.detach(), g

    q0 = torch.as_tensor(rng.normal(size=(8, 100)), device=cuda_device)
    before = cuda_band.launches()
    graphed = tc.GraphedValueAndGrad(vg, q0)
    # the warm-up calls launch; the capture runs nothing and counts nothing
    assert cuda_band.launches() == before + 2 * tc.GRAPH_WARMUP_CALLS
    assert graphed.kernel_launches == {
        "band_matvec": 2, "band_matvec_pair": 0, "band_matvec_pair_t": 0}
    for scale in (0.1, 2.0):
        q = q0 * scale
        before = cuda_band.launches()
        lp_g, g_g = graphed(q)
        assert cuda_band.launches() == before + 2
        lp_e, g_e = vg(q)
        torch.testing.assert_close(lp_g, lp_e, rtol=0, atol=0)
        torch.testing.assert_close(g_g, g_e, rtol=0, atol=0)
