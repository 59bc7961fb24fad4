"""PyTorch port, the whitened FN value-and-grad's kernel route
(ops/centered_vg.py): on the CPU its plain version (the kernel's analytic
forward and backward in torch operations) equals the JAX package's
make_centered_whitened_vg to rtol 1e-10 (gradient atol 1e-8) and the
port's autograd route to rtol 1e-12 (atol 1e-12 of max |g|), float64, on
small FN problems (n = 21, b = 20; n = 41, b = 10) over sigma sampled and
fixed, theta bounded and not, two prior temperatures, a mask with
unobserved points and C = 1 and 4; the clamp's gradient beyond
|log sigma| = 15; non-finite values where f overflows; the dispatch rule;
solve_magi on the route; and the kernel's launch arithmetic in Python:
its tiling (slabs, halos, chain groups, threads, shared memory) and its
row-indexed band copy. On a card (tests marked ``cuda``) the kernel
equals its plain version."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import manifold_constrained_gaussian_process_inference_tpu as jm
from manifold_constrained_gaussian_process_inference_tpu.inference import whiten as jw
from manifold_constrained_gaussian_process_inference_tpu.inference.target import (
    MagiTarget as JTarget,
)
from manifold_constrained_gaussian_process_inference_tpu.inference.transforms import (
    make_theta_transform as j_make_tr,
    unconstrain,
)
from manifold_constrained_gaussian_process_inference_tpu.models import FN_SYSTEM as J_FN
import manifold_constrained_gaussian_process_inference_tpu_torch as mt
from manifold_constrained_gaussian_process_inference_tpu_torch.inference import whiten as tw
from manifold_constrained_gaussian_process_inference_tpu_torch.inference.solve import (
    _init_x_interpolation,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.inference.target import (
    MagiTarget as TTarget,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.inference.transforms import (
    make_theta_transform as t_make_tr,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.models import (
    FN_SYSTEM as T_FN,
    HES1_SYSTEM,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.ops import centered_vg as cv
from manifold_constrained_gaussian_process_inference_tpu_torch.ops import cuda_band
from manifold_constrained_gaussian_process_inference_tpu_torch.ops.gp_cov import GPCov

torch.set_num_threads(1)
THETA = np.array([0.2, 0.2, 3.0])
SIGMA = np.array([0.2, 0.2])
# (n, b, sigma sampled, theta bounded below, prior temperature, unobserved, C)
CASES = {
    "sampled-bounded": (21, 20, True, True, (1.0, 1.0, 1.0), False, 4),
    "fixed-bounded": (21, 20, False, True, (1.0, 1.0, 1.0), False, 1),
    "sampled-free-tempered": (21, 20, True, False, (2.0, 0.5, 1.5), False, 4),
    "fixed-free-masked": (21, 20, False, False, (1.0, 1.0, 1.0), True, 4),
    "sampled-bounded-masked-tempered": (41, 10, True, True, (2.0, 0.5, 1.5), True, 1),
    "fixed-free-n41": (41, 10, False, False, (2.0, 0.5, 1.5), False, 4),
}


def _problem(name):
    """Both packages' targets and one whitener (the JAX package's GN
    whitener at the interpolated start) for one case."""
    n, b, sampled, bounded, temps, masked, c = CASES[name]
    rng = np.random.default_rng(n + b)
    t = np.linspace(0, 6, n)
    y = np.stack([np.sin(t), np.cos(t)], -1) + 0.2 * rng.normal(size=(n, 2))
    if masked:
        y[1::3, 0] = np.nan
        y[::4, 1] = np.nan
    cov_j = jm.build_gp_cov("matern52", np.array([[1.5, 1.5], [1.2, 1.2]]), t, bandsize=b)
    cov_t = GPCov.from_numpy(cov_j)
    lb, ub = J_FN.theta_lower_bound, J_FN.theta_upper_bound
    kw = dict(sigma_init=SIGMA, prior_temperature=temps, sigma_is_fixed=not sampled)
    tr_j = j_make_tr(lb, ub) if bounded else None
    tj = JTarget.build(y, cov_j, J_FN, theta_transform=tr_j, band_impl="dense", **kw)
    tt = TTarget.build(y, cov_t, T_FN, theta_transform=t_make_tr(lb, ub) if bounded else None,
                       band_impl="band", **kw)
    z_theta = unconstrain(tr_j, THETA) if bounded else THETA
    center = np.concatenate([_init_x_interpolation(y, t).T.reshape(-1), z_theta]
                            + ([np.log(SIGMA)] if sampled else []))
    wh_j = jw.build_psi_whitener(cov_j, y, tj, center, temps, jnp.float64)
    wh_t = tw.PsiWhitener.from_numpy(wh_j.W, wh_j.L_T, wh_j.center)
    zetas = np.random.default_rng(2).normal(size=(c, center.shape[0])) * 0.5
    return dict(tj=tj, tt=tt, wh_j=wh_j, wh_t=wh_t, zetas=zetas, cov_t=cov_t, y=y, t=t,
                center=center)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    return _problem(request.param)


def _close_to_autograd(got, want):
    """rtol 1e-12, the gradient with atol 1e-12 of its largest entry."""
    (v, g), (v_a, g_a) = got, want
    np.testing.assert_allclose(v.numpy(), v_a.numpy(), rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), g_a.numpy(), rtol=1e-12,
                               atol=1e-12 * float(g_a.abs().max()))


def test_plain_version_matches_jax(case):
    vg = tw.make_centered_whitened_vg(case["tt"], case["wh_t"])
    assert vg.route == "kernel"
    v_t, g_t = vg(torch.as_tensor(case["zetas"]))
    vg_j = jax.jit(jw.make_centered_whitened_vg(case["tj"], case["wh_j"]))
    for c, zeta in enumerate(case["zetas"]):
        v_j, g_j = vg_j(jnp.asarray(zeta))
        np.testing.assert_allclose(float(v_t[c]), float(v_j), rtol=1e-10)
        np.testing.assert_allclose(g_t[c].numpy(), np.asarray(g_j), rtol=1e-10, atol=1e-8)


def test_plain_version_matches_autograd(case):
    zetas = torch.as_tensor(case["zetas"])
    kernel = tw.make_centered_whitened_vg(case["tt"], case["wh_t"])
    autograd = tw.make_centered_whitened_vg_autograd(case["tt"], case["wh_t"])
    assert autograd.route == "autograd"
    _close_to_autograd(kernel(zetas), autograd(zetas))
    # one zeta without a chain axis
    _close_to_autograd(kernel(zetas[0]), autograd(zetas[0]))


@pytest.mark.parametrize("log_sigma", [16.0, -16.5])
def test_clamped_log_sigma_matches_autograd(log_sigma):
    """Beyond |log sigma| = 15 the clamp holds sigma: the log-sigma
    gradient is 0 there, as torch.clamp's, and the rest still agrees."""
    p = _problem("sampled-bounded")
    wh, tt = p["wh_t"], p["tt"]
    psi = np.tile(p["center"], (3, 1))
    psi[:, -2] = log_sigma
    psi[1, -1] = -log_sigma
    zetas = torch.as_tensor(tw.psi_to_zeta_np(wh, psi))
    _close_to_autograd(tw.make_centered_whitened_vg(tt, wh)(zetas),
                       tw.make_centered_whitened_vg_autograd(tt, wh)(zetas))
    params = cv.make_params(tt, wh.center)
    _, g_psi = cv.centered_fn_vg_torch(torch.as_tensor(psi - p["center"]), params)
    assert (g_psi[:, -2] == 0).all() and (g_psi[1, -1] == 0).all() and (g_psi[0, -1] != 0)


def test_overflowing_f_is_not_finite_on_both_routes():
    p = _problem("fixed-free-masked")
    wh, tt = p["wh_t"], p["tt"]
    psi = np.tile(p["center"], (2, 1))
    psi[1, :5] = 1e120  # V**3 overflows float64
    zetas = torch.as_tensor(tw.psi_to_zeta_np(wh, psi))
    for make in (tw.make_centered_whitened_vg, tw.make_centered_whitened_vg_autograd):
        v, _ = make(tt, wh)(zetas)
        assert np.isfinite(float(v[0])) and not np.isfinite(float(v[1]))


def _route(target):
    wh = tw.PsiWhitener.from_numpy(np.eye(target.dimension), np.eye(target.dimension),
                                   np.zeros(target.dimension))
    return tw.make_centered_whitened_vg(target, wh).route


@pytest.mark.parametrize("change,want", [
    (None, "kernel"),
    ("dense", "autograd"),
    ("hes1", "autograd"),
    ("oversize", "autograd"),
    ("long-grid", "autograd"),
    ("two-sided-theta", "autograd"),
])
def test_dispatch_rule(change, want):
    """Banded FN takes the kernel route; the dense layout, another system,
    a chain state beyond a block's shared memory, a grid beyond MAX_TERMS
    terms an operator and a transform other than the identity or a lower
    bound take autograd."""
    p = _problem("sampled-bounded")
    kw = dict(sigma_init=SIGMA, prior_temperature=(1.0, 1.0, 1.0), sigma_is_fixed=False,
              theta_transform=t_make_tr(T_FN.theta_lower_bound, T_FN.theta_upper_bound))
    target = TTarget.build(p["y"], p["cov_t"], T_FN, band_impl="band", **kw)
    if change == "dense":
        target = TTarget.build(p["y"], p["cov_t"], T_FN, band_impl="dense", **kw)
    elif change == "hes1":
        target = dataclasses.replace(target, system=HES1_SYSTEM)
    elif change == "oversize":
        n = target.n_times
        b_max = max(b for b in range(0, 5000)
                    if cv.chain_bytes(-(-n // cv.cluster_size(n, b)), b) <= cv.MAX_SHARED_BYTES)
        assert cv.takes(dataclasses.replace(target, bandwidth=b_max))
        target = dataclasses.replace(target, bandwidth=b_max + 1)
    elif change == "long-grid":
        n_max = cv.MAX_TERMS // 81
        assert cv.takes(dataclasses.replace(target, n_times=n_max, bandwidth=40))
        target = dataclasses.replace(target, n_times=n_max + 1, bandwidth=40)
    elif change == "two-sided-theta":
        target = TTarget.build(p["y"], p["cov_t"], T_FN, band_impl="band", **{
            **kw, "theta_transform": t_make_tr([0.0, 0.0, 0.0], [1.0, 1.0, 10.0])})
    assert cv.takes(target) == (want == "kernel")
    if change not in ("oversize", "long-grid"):
        assert _route(target) == want


def test_kernel_source_agrees_with_the_wrapper():
    """The kernel's constants (rows a unit, threads, cluster, sums,
    parameters, partial lanes, staged vectors, tail offset, argument
    counts) and its shared-memory formula are the wrapper's."""
    import re

    src = cv.SOURCE.read_text()
    const = lambda name: int(re.search(rf"{name} = (\d+)", src).group(1))  # noqa: E731
    assert const("kRows") == cv.ROWS
    assert const("kMaxThreads") == cv.MAX_THREADS
    assert const("kMaxCluster") == cv.MAX_CLUSTER
    assert const("kSums") == cv.N_SUMS
    assert const("kParams") == cv.N_PARAMS
    assert const("kLanes") == cv.PART_LANES
    assert const("kVectors") == cv.VECTORS
    assert const("kTail") == cv.TAIL
    assert const("kNPointers") == len(cv.POINTERS)
    assert const("kNInts") == len(cv.INTS)
    assert "return kParams + kSums + static_cast<size_t>(kLanes) * groups_of(slab) +" in src
    # the diagonal copy's padding (diag_shape)
    assert "int terms_of(int b) { return (2 * b + 1 + 7) / 8 * 8; }" in src
    assert "int cols_of(int n) { return (n + kRows + 1) / 2 * 2; }" in src
    assert cv.diag_shape(397, 40) == (88, 400) and cv.diag_shape(41, 20) == (48, 44)
    assert "static_cast<size_t>(kVectors) * 2 * width_of(slab, b);" in src
    assert "return groups_of(slab) * kRows + 2 * b;" in src
    # [slice]'s tiling at 128 chains: slabs of 50 rows, 25 units a state
    assert cv.chain_bytes(50, 40) == 8 * (8 + 8 + 4 * 25 + 3 * 2 * (25 * 2 + 80))
    assert cv.tiling(397, 40, 128).shared_bytes == 8 * cv.chain_bytes(50, 40)


@pytest.mark.parametrize("n,b", [(41, 20), (21, 20), (30, 3), (9, 0)])
def test_kernel_band_copy_holds_the_operator(n, b):
    """The kernel's diagonal copy (``band_diags``) of band storages: term k
    of row i at [b + k, i] is A[i, i + k], the product summed from it over
    k = -b..b equals ``ops/band.band_storage_matvec_torch`` (float64, 1e-13
    of the largest term), and every padded entry (terms past b, rows past
    n, i + k outside the grid) is zero."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.ops.band import (
        band_storage_matvec_torch,
    )

    rng = np.random.default_rng(n + b)
    bands = torch.as_tensor(rng.normal(size=(2, 3, 2 * b + 1, n)))
    x = torch.as_tensor(rng.normal(size=(2, 3, n)))
    diags = cv.band_diags(bands, b)
    assert tuple(diags.shape) == (2, 3, *cv.diag_shape(n, b))
    k = torch.arange(-b, b + 1)[:, None]
    i = torch.arange(n)[None, :]
    inside = (i + k >= 0) & (i + k < n)
    x_at = torch.where(inside, x[..., (i + k).clamp(0, n - 1)], 0.0)  # x[i + k]
    got = torch.sum(diags[..., : 2 * b + 1, :n] * x_at, dim=-2)
    want = band_storage_matvec_torch(bands.reshape(6, 2 * b + 1, n), x.reshape(6, n), b)
    torch.testing.assert_close(got.reshape(6, n), want, rtol=0, atol=1e-13 * float(
        (bands.abs().max() * x.abs().max())))
    assert not diags[..., 2 * b + 1:, :].any() and not diags[..., n:].any()
    assert not torch.where(inside, 0.0, diags[..., : 2 * b + 1, :n]).any()


# the grids of the kernel's paths: [resume]'s, [slice]'s, config 4's, the
# filllevel-5 grid's
GRIDS = [(41, 20), (397, 40), (793, 80), (3169, 160)]


@pytest.mark.parametrize("n,b", GRIDS)
def test_tiling_covers_every_output_once_and_its_halos(n, b):
    """The slabs of a cluster's blocks cover the grid's rows once, none
    empty; a block's staged vectors hold its slab and b rows each side,
    each halo row read from the block that owns it (an adjacent one,
    since a slab keeps at least b rows), at a position inside the owner's
    slab; and a unit's windows stay inside the staged vector. A banded
    product computed slab by slab from those staged vectors (positions
    outside the grid zero) is the whole product's, bit for bit."""
    tile = cv.tiling(n, b, 128)
    slab, s = tile.slab, tile.cluster
    rows = np.concatenate([np.arange(lo, hi) for lo, hi in tile.slabs])
    assert np.array_equal(rows, np.arange(n)) and all(hi > lo for lo, hi in tile.slabs)
    assert 1 <= s <= cv.MAX_CLUSTER and (s == 1 or (slab >= b and slab % 2 == 0))
    groups = -(-slab // cv.ROWS)
    width = groups * cv.ROWS + 2 * b
    rng = np.random.default_rng(n)
    band = rng.normal(size=(2 * b + 1, n))
    x = rng.normal(size=n)
    whole = np.zeros(n)
    for i in range(n):
        for k in range(max(-b, -i), min(b, n - 1 - i) + 1):
            whole[i] += band[b + k, i + k] * x[i + k]
    by_slab = np.zeros(n)
    for rank, (lo, hi) in enumerate(tile.slabs):
        base = lo - b
        staged = np.zeros(width)
        for j in range(max(0, base), min(n, base + width)):
            owner = j // slab
            if lo <= j < hi:
                assert owner == rank
            elif j < lo - b or j >= hi + b:
                continue  # never read by a row of the slab
            else:
                assert abs(owner - rank) == 1
                lo_q, hi_q = tile.slabs[owner]
                assert lo_q <= j < hi_q and b <= j - (owner * slab - b) < b + slab
            staged[j - base] = x[j]
        for g in range(groups):
            i0 = lo + g * cv.ROWS
            kmin, kmax = max(-b, -(i0 + cv.ROWS - 1)), min(b, n - 1 - i0)
            for r in range(cv.ROWS):
                i = i0 + r
                assert 0 <= i0 - base + kmin + r and i0 - base + kmax + r < width
                if i >= hi:
                    continue
                acc = 0.0
                for k in range(kmin, kmax + 1):
                    inside = 0 <= i + k < n
                    coef = band[b + k, i + k] if inside else 0.0
                    acc += coef * staged[i0 - base + k + r]
                by_slab[i] = acc
    assert np.array_equal(by_slab, whole)


@pytest.mark.parametrize("n,b", GRIDS)
def test_tiling_depends_on_the_chains_only_through_the_groups(n, b):
    """S and the slabs are the same at C = 1, 3, 32 and 128 (a chain's
    bits depend on them alone); the chain groups fill the card's blocks as
    shared memory allows, each a whole number of thread units, and G
    leaves a block MIN_UNITS units unless it is 1; a block's threads cover
    its units in passes of at most MAX_THREADS; its
    shared memory is within the H100's 232,448 bytes."""
    tiles = {c: cv.tiling(n, b, c) for c in (1, 3, 32, 128)}
    assert len({(t.cluster, t.slab, t.slabs) for t in tiles.values()}) == 1
    assert tiles[1].chains == 1
    for c, t in tiles.items():
        assert t.shared_bytes <= 232448 == cv.MAX_SHARED_BYTES
        assert 1 <= t.chains <= c and t.chains % t.per_thread == 0 and t.per_thread in (1, 2, 4, 8)
        assert t.clusters == -(-c // t.chains)
        groups = -(-t.slab // cv.ROWS)
        units = 2 * groups * (t.chains // t.per_thread)
        padded = 2 * 32 * (-(-groups // 32)) * (t.chains // t.per_thread)  # whole warps a state
        assert t.split == (t.chains == 1 and 2 * padded <= cv.MAX_THREADS)
        padded *= 2 if t.split else 1  # a unit's operators on two threads
        passes = -(-padded // t.threads)
        assert t.threads % 32 == 0 and t.threads <= cv.MAX_THREADS
        assert passes == -(-padded // cv.MAX_THREADS)
        assert t.per_thread == 1 or units >= cv.MIN_UNITS
    # at 128 chains one wave of at most TARGET_BLOCKS blocks, unless a
    # cluster's shared memory holds no more chains
    t = tiles[128]
    assert (t.cluster * t.clusters <= cv.TARGET_BLOCKS
            or (t.chains + cv.MAX_PER_THREAD) * cv.chain_bytes(t.slab, b)
            > cv.MAX_SHARED_BYTES)


def test_card_entry_refuses_a_cpu_tensor():
    """The kernel's entry point takes CUDA tensors only: a CPU tensor is
    refused before any build, never run through the plain version."""
    p = _problem("fixed-free-n41")
    params = cv.make_params(p["tt"], p["center"])
    dpsi = torch.as_tensor(p["zetas"] @ p["wh_t"].W.numpy().T)
    with pytest.raises(ValueError, match="CUDA device"):
        cv.centered_fn_vg_cuda(dpsi, params)


def test_cpu_route_launches_no_kernel():
    """The plain version runs on CPU tensors; the launch count stays."""
    p = _problem("fixed-free-n41")
    before = dict(cuda_band.KERNEL_LAUNCHES)
    tw.make_centered_whitened_vg(p["tt"], p["wh_t"])(torch.as_tensor(p["zetas"]))
    assert cuda_band.KERNEL_LAUNCHES == before


def test_cpu_route_keeps_the_matmul_gemms(monkeypatch):
    """On CPU tensors the whitening GEMMs stay torch.matmul: nothing is
    prepared for the product kernel and no product launches, at a shape
    whose GEMMs take the kernel on the card."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.ops import minv_mv

    def never(*args, **kwargs):
        raise AssertionError("the product kernel's wrapper ran on CPU tensors")

    monkeypatch.setattr(minv_mv, "prepare", never)
    monkeypatch.setattr(minv_mv, "product", never)
    p = _problem("fixed-free-n41")
    zetas = torch.as_tensor(p["zetas"]).repeat(8, 1)  # 32 chains
    assert cv.gemm_takes_kernel(*zetas.shape)
    before = dict(minv_mv.LAUNCHES)
    lp, g = tw.make_centered_whitened_vg(p["tt"], p["wh_t"])(zetas)
    assert lp.shape == (32,) and g.shape == zetas.shape
    assert minv_mv.LAUNCHES == before


def test_solve_magi_runs_the_kernel_route():
    """solve_magi on whitened banded FN (the CPU) takes the route and meets
    tests/test_torch_solve.py's loose recovery bars."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.utils.integrators import (
        integrate_system, sample_on_grid,
    )

    rng = np.random.default_rng(0)
    ts, xs = integrate_system(mt.FN_SYSTEM, [-1.0, 1.0], 0.0, 8.0, THETA, 800)
    t = np.linspace(0.0, 8.0, 21)
    y = sample_on_grid(ts.numpy(), xs.numpy(), t) + 0.1 * rng.normal(size=(21, 2))
    config = mt.MagiConfig(
        niter_hmc=120, burnin_ratio=0.5, step_size_factor=0.06, n_chains=4,
        mass_matrix="dense-pooled", chain_init_jitter=0.05, x_whitened=True,
        theta_constrained=True, target_accept_ratio=0.95, step_jitter=0.125, seed=7,
        chunk_size=40, band_impl="band", device="cpu",
    )
    res = mt.solve_magi(y, t, mt.FN_SYSTEM, config)
    assert res.diagnostics["vg_route"] == "kernel"
    assert np.all(np.abs(res.theta.mean(0) - THETA) < np.array([0.2, 0.3, 0.8]))
    assert np.all(np.abs(res.sigma.mean(0) - 0.1) < 0.08)
    assert np.sqrt(np.nanmean((res.x_sampled.mean(0) - y) ** 2)) < 0.3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sampled-bounded", "fixed-free-masked"])
def test_cuda_kernel_matches_the_plain_version(cuda_device, name):
    p = _problem(name)
    tt = dataclasses.replace(p["tt"], data=type(p["tt"].data)(
        *(a.to(cuda_device) for a in p["tt"].data)))
    params = cv.make_params(tt, p["center"])
    dpsi = torch.as_tensor(p["zetas"] @ p["wh_t"].W.numpy().T, device=cuda_device)
    before = cuda_band.KERNEL_LAUNCHES[cv.NAME]
    got = cv.centered_fn_vg(dpsi, params)
    want = cv.centered_fn_vg_torch(dpsi, params)
    torch.cuda.synchronize()
    assert cuda_band.KERNEL_LAUNCHES[cv.NAME] == before + 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12 * float(b.abs().max()))
