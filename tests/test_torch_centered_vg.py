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
its tiling (slabs of whole row tiles, halos, chain groups of whole N
tiles, threads, shared memory) and its prepared band tiles, whose tile
products, slab by slab, are the banded products. On a card (tests marked
``cuda``) the kernel equals its plain version."""
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
        slab = cv.tiling(target.n_times, 0, 1).slab  # the slabs depend on n alone
        b_max = max(b for b in range(0, 5000)
                    if cv.chain_bytes(slab, b) <= cv.MAX_SHARED_BYTES - cv.warps(slab) * cv.MIN_SLOTS * (cv.SLOT_BYTES + 8))
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
    """The kernel's constants (tile rows, k step, N tile, N tiles, warps,
    cluster, ring, sums, parameters, partial lanes, staged vectors, tail
    offset, argument counts) and its shared-memory formula are the
    wrapper's."""
    import re

    src = cv.SOURCE.read_text()
    const = lambda name: int(re.search(rf"{name} = (\d+)", src).group(1))  # noqa: E731
    assert const("kTileRows") == cv.TILE_ROWS
    assert const("kStep") == cv.STEP
    assert const("kChainTile") == cv.CHAIN_TILE
    assert const("kMaxNTiles") == cv.MAX_NTILES
    assert const("kMaxWarps") == cv.MAX_WARPS
    assert const("kMaxCluster") == cv.WAVE_CLUSTER
    assert const("kSlots") == cv.RING_SLOTS
    assert const("kRingBytes") == cv.RING_BYTES
    assert const("kSlotBytes") == cv.SLOT_BYTES
    assert const("kFragElems") == cv.FRAG_ELEMS
    assert const("kSums") == cv.N_SUMS
    assert const("kParams") == cv.N_PARAMS
    assert const("kLanes") == cv.PART_LANES
    assert const("kVectors") == cv.VECTORS
    assert const("kTail") == cv.TAIL
    assert const("kNPointers") == len(cv.POINTERS)
    assert const("kNInts") == len(cv.INTS)
    assert ("return kParams + kSums + kMaxCluster * (kSums - 1) + "
            "static_cast<size_t>(kLanes) * groups_of(slab) +") in src
    assert "static_cast<size_t>(kVectors) * 2 * stride_of(slab, b);" in src
    assert "int groups_of(int slab) { return slab / 2; }" in src
    assert "return (kTileRows + 2 * b + kStep - 1) / kStep;" in src
    assert "return slab - kTileRows + kStep * ksteps_of(b);" in src
    assert "return w + ((4 - w) % 16 + 16) % 16;" in src
    assert ("return static_cast<size_t>(warps_of(slab)) * ring_slots_of(slab, b, chains) * "
            "(kSlotBytes + 8);") in src
    assert ("const long long most = kRingBytes / (warps * kSlotBytes), "
            "room = left / (warps * (kSlotBytes + 8));") in src
    assert const("kMaxShared") == cv.MAX_SHARED_BYTES
    assert "return items < kMaxWarps ? items : kMaxWarps;" in src
    assert cv.ksteps(40) == 12 and cv.ksteps(20) == 7 and cv.ksteps(80) == 22
    # [slice]'s tiling at 128 chains: 5 slabs of five tiles, 8 chains, the
    # windows 160 positions at a stride of 164, 10 warps' rings of 4 slots
    assert cv.chain_bytes(80, 40) == 8 * (12 + 8 + 5 * 7 + 4 * 40 + 3 * 2 * 164)
    assert cv.ring_slots(80, 40, 8) == 4 and cv.ring_bytes(80, 40, 8) == 10 * 4 * (2048 + 8)
    assert cv.ring_slots(64, 40, 8) == 6
    t = cv.tiling(397, 40, 128)
    assert (t.cluster, t.slab, t.chains, t.clusters, t.threads) == (5, 80, 8, 16, 320)
    assert t.shared_bytes == cv.ring_bytes(80, 40, 8) + 8 * cv.chain_bytes(80, 40)


def _operator(bands, b, n):
    """The dense (..., n, n) operators of band storages (..., 2b+1, n):
    A[i, j] = bands[b + j - i, j] for |i - j| <= b."""
    i = torch.arange(n)[:, None]
    j = torch.arange(n)[None, :]
    inside = (j - i).abs() <= b
    k = (b + j - i).clamp(0, 2 * b)
    dense = bands[..., k, j.expand(n, n)]
    return torch.where(inside, dense, 0.0)


def _tile_matrices(tiles):
    """The prepared copy (..., k steps, 128) as 16 x 8 matrices: entry
    [4 lane + 2 h + e] is row lane // 4 + 8 e, column lane % 4 + 4 h."""
    f = tiles.reshape(*tiles.shape[:-1], 8, 4, 2, 2)  # [g][t][h][e]
    return f.permute(*range(f.dim() - 4), -1, -4, -2, -3).reshape(*tiles.shape[:-1], 16, 8)


@pytest.mark.parametrize("n,b", [(41, 20), (21, 20), (30, 3), (9, 0)])
def test_kernel_band_copy_holds_the_operator(n, b):
    """The kernel's prepared copy (``prepare_tiles_torch``) of band
    storages: row tile rt's k step ks holds the operator's rows 16 rt..
    and columns 16 rt - b + 8 ks.. in the A fragments' order, the tiles'
    products over each window equal ``ops/band.band_storage_matvec_torch``
    (float64, 1e-13 of the largest term), and every entry outside the
    band, the grid and the last tile's rows is zero."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.ops.band import (
        band_storage_matvec_torch,
    )

    rng = np.random.default_rng(n + b)
    bands = torch.as_tensor(rng.normal(size=(2, 3, 2 * b + 1, n)))
    x = torch.as_tensor(rng.normal(size=(2, 3, n)))
    tiles = cv.prepare_tiles_torch(bands, b)
    n_tiles, k = -(-n // 16), cv.ksteps(b)
    assert tuple(tiles.shape) == (2, 3, n_tiles, k, 128) and tiles.dtype == bands.dtype
    mats = _tile_matrices(tiles)  # (2, 3, tiles, k, 16, 8)
    xp = torch.nn.functional.pad(x, (b, 16 * n_tiles + 8 * k - n - b))  # x[j] at j + b
    got = torch.zeros(2, 3, 16 * n_tiles, dtype=torch.float64)
    for rt in range(n_tiles):
        for ks in range(k):
            window = xp[..., 16 * rt + 8 * ks: 16 * rt + 8 * ks + 8]  # columns 16 rt - b + 8 ks..
            got[..., 16 * rt: 16 * rt + 16] += torch.einsum("abij,abj->abi", mats[:, :, rt, ks],
                                                            window)
    want = band_storage_matvec_torch(bands.reshape(6, 2 * b + 1, n), x.reshape(6, n), b)
    torch.testing.assert_close(got[..., :n].reshape(6, n), want, rtol=0, atol=1e-13 * float(
        (bands.abs().max() * x.abs().max())))
    assert not got[..., n:].any()


# the paths' shapes (chains, n, b): [slice], [chees], a [mesh] rank,
# [envelope], [resume], config 4, one chain
SHAPES = {"slice": (128, 397, 40), "chees": (64, 397, 40), "mesh": (32, 397, 40),
          "envelope": (128, 397, 40), "resume": (8, 41, 20), "n793": (128, 793, 80),
          "c1": (1, 397, 40)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", list(SHAPES))
def test_prepared_tiles_hold_the_dense_operators(name, dtype):
    """At each path's grid and in both storage types, every entry of the
    prepared copy is the dense operator's at its (row, column), converted
    in the storages' type, or zero where that lies outside the band,
    outside the grid or in the last tile's rows past n."""
    _, n, b = SHAPES[name]
    rng = np.random.default_rng(n)
    bands = torch.as_tensor(rng.normal(size=(6, 2, 2 * b + 1, n)), dtype=dtype)
    tiles = cv.prepare_tiles_torch(bands, b)
    n_tiles, k = -(-n // 16), cv.ksteps(b)
    assert tuple(tiles.shape) == cv.tiles_shape(n, b) == (6, 2, n_tiles, k, 128)
    assert tiles.dtype == dtype
    dense = _operator(bands.double(), b, n)  # (6, 2, n, n)
    # the dense operator padded so that every tile's window is in range
    pad = torch.nn.functional.pad(dense, (b, 16 * n_tiles + 8 * k - n - b, 0, 16 * n_tiles - n))
    mats = _tile_matrices(tiles)
    for rt in range(n_tiles):
        rows = pad[:, :, 16 * rt: 16 * rt + 16]
        for ks in range(k):
            want = rows[..., 16 * rt + 8 * ks: 16 * rt + 8 * ks + 8]  # columns 16 rt - b + 8 ks..
            assert torch.equal(mats[:, :, rt, ks].double(), want), (rt, ks)
    assert torch.count_nonzero(tiles) == torch.count_nonzero(dense)


@pytest.mark.parametrize("name", list(SHAPES))
def test_tiling_at_the_paths_shapes(name):
    """At each path's shape: slabs of whole row tiles covering the grid
    (the last may be shorter), S at most WAVE_CLUSTER and the same at any C,
    the halo's reach enough for b rows each side, one chain a cluster
    where a block a chain fits TARGET_BLOCKS (one padded N tile), else Cg
    a multiple of 8 at most MAX_NTILES N tiles, the clusters covering C,
    and the block's shared memory within the card's."""
    c, n, b = SHAPES[name]
    t = cv.tiling(n, b, c)
    assert t.slab % cv.TILE_ROWS == 0 and 1 <= t.cluster <= cv.WAVE_CLUSTER
    assert t.slab * t.cluster >= n > t.slab * (t.cluster - 1)
    assert t.slabs[0][0] == 0 and t.slabs[-1][1] == n
    assert all(hi - lo == t.slab for lo, hi in t.slabs[:-1])
    assert (t.cluster, t.slab) == cv.tiling(n, b, 1)[:2]
    assert t.cluster == 1 or t.reach * t.slab >= b > (t.reach - 1) * t.slab
    if c * t.cluster <= cv.TARGET_BLOCKS:
        assert t.chains == 1 and t.ntiles == 1
    else:
        assert t.chains % cv.CHAIN_TILE == 0 and t.ntiles == t.chains // cv.CHAIN_TILE
        assert 1 <= t.ntiles <= cv.MAX_NTILES
    assert t.clusters == -(-c // t.chains)
    assert t.shared_bytes == cv.ring_bytes(t.slab, b, t.chains) + t.chains * cv.chain_bytes(t.slab, b)
    assert cv.MIN_SLOTS <= cv.ring_slots(t.slab, b, t.chains) <= cv.RING_SLOTS
    assert t.shared_bytes <= cv.MAX_SHARED_BYTES
    assert t.threads == 32 * min(2 * t.slab // cv.TILE_ROWS, cv.MAX_WARPS)
    assert cv.ring_bytes(t.slab, b, t.chains) <= cv.RING_BYTES + 8 * cv.RING_SLOTS * cv.MAX_WARPS


@pytest.mark.parametrize("n,s", [(9, 1), (41, 1), (96, 1), (97, 4), (160, 5), (397, 5),
                                 (793, 5), (3169, 5)])
def test_cluster_size_by_grid(n, s):
    """S is 1 where one block has a warp for every (tile, state) item
    (n <= 96 at 12 warps: [resume]'s n = 41 runs one block a cluster, with
    no cluster barrier or halo exchange), else the least number of slabs
    of whole tiles up to WAVE_CLUSTER; the slabs then hold at most
    MAX_WARPS / 2 tiles only where S is 1."""
    t = cv.tiling(n, 20, 8)
    assert t.cluster == s
    tiles = -(-n // cv.TILE_ROWS)
    assert (t.cluster == 1) == (2 * tiles <= cv.MAX_WARPS)
    if t.cluster == 1:
        assert t.slab == cv.TILE_ROWS * tiles and t.reach == 0
        assert t.threads == 32 * 2 * tiles


def test_tiling_raises_where_a_chain_cannot_fit():
    """A band whose chain state exceeds a block's shared memory beside the
    ring is refused with a ValueError, and so the route is not taken."""
    n = 397
    slab = cv.tiling(n, 0, 1).slab
    b_max = max(b for b in range(0, 3000)
                if cv.chain_bytes(slab, b) <= cv.MAX_SHARED_BYTES - cv.warps(slab) * cv.MIN_SLOTS * (cv.SLOT_BYTES + 8))
    assert cv.tiling(n, b_max, 1).chains == 1
    with pytest.raises(ValueError, match="shared memory"):
        cv.tiling(n, b_max + 1, 1)


# the grids of the kernel's paths: [resume]'s, [slice]'s, config 4's, the
# filllevel-5 grid's
GRIDS = [(41, 20), (397, 40), (793, 80), (3169, 160)]


@pytest.mark.parametrize("n,b", GRIDS)
def test_tiling_covers_every_output_once_and_its_halos(n, b):
    """The slabs of a cluster's blocks cover the grid's rows once, none
    empty, in whole row tiles; a block's staged vectors hold its tiles'
    windows, each halo row within b of its slab read from the block that
    owns it (within the tiling's reach), at a position inside the owner's
    slab; and a banded product computed slab by slab as the kernel does,
    from the prepared tiles and those staged vectors (positions outside
    the grid zero, the rest never put left at zero), is the whole
    product's, bit for bit (integer data, so every order of summation is
    exact)."""
    tile = cv.tiling(n, b, 128)
    slab, s, k = tile.slab, tile.cluster, cv.ksteps(b)
    rows = np.concatenate([np.arange(lo, hi) for lo, hi in tile.slabs])
    assert np.array_equal(rows, np.arange(n)) and all(hi > lo for lo, hi in tile.slabs)
    width = slab - cv.TILE_ROWS + cv.STEP * k
    assert width >= slab + 2 * b
    rng = np.random.default_rng(n)
    band = torch.as_tensor(rng.integers(-4, 5, size=(1, 2 * b + 1, n)).astype(np.float64))
    x = rng.integers(-4, 5, size=(3, n)).astype(np.float64)
    mats = _tile_matrices(cv.prepare_tiles_torch(band, b))[0].numpy()  # (tiles, k, 16, 8)
    whole = x @ _operator(band[0], b, n).numpy().T
    by_slab = np.zeros((3, n))
    for rank, (lo, hi) in enumerate(tile.slabs):
        base = lo - b
        staged = np.zeros((3, width))
        for j in range(max(0, base), min(n, base + width)):
            if j < lo - b or j >= hi + b:
                continue  # never put: multiplied by zero coefficients only
            owner = j // slab
            assert abs(owner - rank) <= tile.reach
            lo_q, hi_q = tile.slabs[owner]
            assert lo_q <= j < hi_q and lo_q - b <= j < hi_q + b
            staged[:, j - base] = x[:, j]
        for q in range(-(-(hi - lo) // cv.TILE_ROWS)):
            acc = np.zeros((16, 3))
            for ks in range(k):
                p0 = cv.TILE_ROWS * q + cv.STEP * ks
                assert p0 + cv.STEP <= width
                acc += mats[lo // cv.TILE_ROWS + q, ks] @ staged[:, p0:p0 + cv.STEP].T
            for r in range(16):
                if lo + 16 * q + r < hi:
                    by_slab[:, lo + 16 * q + r] = acc[r]
    assert np.array_equal(by_slab, whole)


@pytest.mark.parametrize("n,b", GRIDS)
def test_tiling_depends_on_the_chains_only_through_the_groups(n, b):
    """S and the slabs are the same at C = 1, 3, 32 and 128 (a chain's
    bits depend on them alone); one chain a cluster where a block a chain
    fits TARGET_BLOCKS blocks, else whole N tiles of 8 as shared memory
    allows, or one N tile of as many as fit; a warp per
    stage item up to MAX_WARPS; a block's shared memory is within the
    H100's 232,448 bytes."""
    tiles = {c: cv.tiling(n, b, c) for c in (1, 3, 32, 128)}
    assert len({(t.cluster, t.slab, t.slabs, t.reach) for t in tiles.values()}) == 1
    assert tiles[1].chains == 1 and tiles[3].chains == 1
    fits = (cv.MAX_SHARED_BYTES - cv.warps(tiles[1].slab) * cv.MIN_SLOTS * (cv.SLOT_BYTES + 8)) // cv.chain_bytes(tiles[1].slab, b)
    for c, t in tiles.items():
        assert t.shared_bytes <= 232448 == cv.MAX_SHARED_BYTES
        assert 1 <= t.chains <= max(c, cv.CHAIN_TILE)
        if c * t.cluster <= cv.TARGET_BLOCKS:
            assert t.chains == 1
        elif fits >= cv.CHAIN_TILE:
            assert t.chains % cv.CHAIN_TILE == 0
        else:
            assert t.chains == fits
        assert t.clusters == -(-c // t.chains)
        assert t.threads == 32 * min(2 * t.slab // cv.TILE_ROWS, cv.MAX_WARPS)
    # at 128 chains one wave of at most TARGET_BLOCKS blocks, unless a
    # cluster's shared memory holds no more chains or MAX_NTILES caps them
    t = tiles[128]
    assert (t.cluster * t.clusters <= cv.TARGET_BLOCKS or t.ntiles == cv.MAX_NTILES
            or (t.chains + cv.CHAIN_TILE) * cv.chain_bytes(t.slab, b)
            > cv.MAX_SHARED_BYTES - cv.warps(t.slab) * cv.MIN_SLOTS * (cv.SLOT_BYTES + 8))


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
