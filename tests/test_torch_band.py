"""PyTorch port, band storage: the band matvec and the paired band matvec
against three references (the JAX package's XLA band_matvec, the Pallas
kernel in interpret mode as tests/test_band_impl.py runs it, and the dense
einsum), forward and autograd backward, with the chain axis and the edge
shapes (tests/test_torch_band_wide.py adds a bandwidth above the TPU
kernel's limit of 64). On a CPU tensor
the wrappers run the plain versions; the kernels themselves are checked
against them by the tests marked ``cuda``, which run on the card only."""
import re
from functools import lru_cache, partial

import jax
import jax.experimental.pallas as plx
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import manifold_constrained_gaussian_process_inference_tpu.ops.pallas_band as pb
from manifold_constrained_gaussian_process_inference_tpu.ops.band import (
    dense_to_band_storage,
    mat2band,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.ops import cuda_band as cb
from manifold_constrained_gaussian_process_inference_tpu_torch.ops.band import (
    band_matvec_pair_t_torch,
    band_matvec_pair_torch,
    band_storage_matvec_torch,
)

torch.set_num_threads(1)

# (n, b): regular, n < W = 2b+1, b = 0, n not a multiple of the kernel tile
SHAPES = [(33, 5), (7, 5), (23, 0), (130, 3)]


def _problem(n, b, m=2, c=3, seed=0):
    rng = np.random.default_rng(seed + 7 * n + b)
    dense = np.stack([mat2band(rng.normal(size=(n, n)), b, b) for _ in range(m)])
    bs = np.stack([dense_to_band_storage(a, b) for a in dense])
    bst = np.stack([pb.transpose_band_storage(s, b) for s in bs])
    xs = rng.normal(size=(c, m, n))
    return dense, bs, bst, xs


def _jax_xla(bs, bst, x, b):
    return np.asarray(pb.band_matvec(jnp.asarray(bs), jnp.asarray(bst), jnp.asarray(x), b, False))


def _jax_pallas(bs, x, b):
    kernel = partial(pb._band_matvec_kernel, bandwidth=b, n=bs.shape[-1], m=bs.shape[0])
    return np.asarray(plx.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float64), interpret=True,
    )(jnp.asarray(bs), jnp.asarray(x)))


@pytest.mark.parametrize("n,b", SHAPES)
def test_transpose_band_storage_matches_jax(n, b):
    _, bs, _, _ = _problem(n, b)
    for s in bs:
        np.testing.assert_array_equal(
            cb.transpose_band_storage(s, b), pb.transpose_band_storage(s, b)
        )


@pytest.mark.parametrize("n,b", SHAPES)
def test_forward_matches_three_references(n, b):
    dense, bs, bst, xs = _problem(n, b)
    got = cb.band_matvec(torch.as_tensor(bs), torch.as_tensor(bst), torch.as_tensor(xs), b)
    want_dense = np.einsum("mij,cmj->cmi", dense, xs)
    want_xla = np.stack([_jax_xla(bs, bst, x, b) for x in xs])
    want_pallas = np.stack([_jax_pallas(bs, x, b) for x in xs])
    for want in (want_dense, want_xla, want_pallas):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n,b", SHAPES)
def test_backward_matches_jax_vjp(n, b):
    dense, bs, bst, xs = _problem(n, b)
    x = torch.as_tensor(xs[0]).requires_grad_(True)
    val = torch.sum(torch.sin(cb.band_matvec(torch.as_tensor(bs), torch.as_tensor(bst), x, b)))
    (g_t,) = torch.autograd.grad(val, x)

    def f(v):
        return jnp.sum(jnp.sin(pb.band_matvec(jnp.asarray(bs), jnp.asarray(bst), v, b, False)))

    v_j, g_j = jax.value_and_grad(f)(jnp.asarray(xs[0]))
    np.testing.assert_allclose(float(val.detach()), float(v_j), rtol=1e-12)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-11, atol=1e-12)
    g_dense = np.einsum("mij,mi->mj", dense, np.cos(np.einsum("mij,mj->mi", dense, xs[0])))
    np.testing.assert_allclose(g_t.numpy(), g_dense, rtol=1e-11, atol=1e-12)


def _pair_problem(n, b, c=3):
    dense_a, bs_a, bst_a, xs = _problem(n, b, c=c)
    dense_b, bs_b, bst_b, _ = _problem(n, b, c=c, seed=1)
    return (dense_a, bs_a, bst_a), (dense_b, bs_b, bst_b), xs


def _pair_apply(a, b_, xs, b):
    t = torch.as_tensor
    return cb.band_matvec_pair(t(a[1]), t(a[2]), t(b_[1]), t(b_[2]), xs, b)


@pytest.mark.parametrize("n,b", SHAPES)
def test_pair_forward_matches_jax(n, b):
    """(A x, B x) from one paired call equals the JAX package's XLA
    band_matvec and its Pallas kernel in interpret mode, for each stack."""
    a, b_, xs = _pair_problem(n, b)
    got_a, got_b = _pair_apply(a, b_, torch.as_tensor(xs), b)
    for got, (dense, bs, bst) in ((got_a, a), (got_b, b_)):
        for want in (np.einsum("mij,cmj->cmi", dense, xs),
                     np.stack([_jax_xla(bs, bst, x, b) for x in xs]),
                     np.stack([_jax_pallas(bs, x, b) for x in xs])):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n,b", SHAPES)
def test_pair_backward_matches_jax_vjp(n, b):
    """The paired op's autograd backward (A^T g_a + B^T g_b in one call)
    equals the JAX package's VJP of the two band_matvecs, XLA path and
    Pallas kernel in interpret mode."""
    a, b_, xs = _pair_problem(n, b, c=2)
    x = torch.as_tensor(xs).requires_grad_(True)
    ya, yb = _pair_apply(a, b_, x, b)
    val = torch.sum(torch.sin(ya)) + torch.sum(torch.cos(yb) * ya)
    (g_t,) = torch.autograd.grad(val, x)

    def f(v, matvec):
        ja, jb = matvec(a, v), matvec(b_, v)
        return jnp.sum(jnp.sin(ja)) + jnp.sum(jnp.cos(jb) * ja)

    def xla(ops, v):
        bs, bst = jnp.asarray(ops[1]), jnp.asarray(ops[2])
        return jax.vmap(lambda vi: pb.band_matvec(bs, bst, vi, b, False))(v)

    for matvec in (xla, lambda ops, v: _pallas_vjp_matvec(ops, v, b)):
        v_j, g_j = jax.value_and_grad(f)(jnp.asarray(xs), matvec)
        np.testing.assert_allclose(float(val.detach()), float(v_j), rtol=1e-12)
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-12, atol=1e-12)


def _pallas_vjp_matvec(ops, v, b):
    """The JAX package's band matvec with its Pallas kernel in interpret
    mode on both passes: forward on the storage, backward on the transposed
    storage (as its custom_vjp does)."""
    bs, bst = jnp.asarray(ops[1]), jnp.asarray(ops[2])

    def run(storage, x):
        kernel = partial(pb._band_matvec_kernel, bandwidth=b, n=x.shape[-1], m=x.shape[-2])
        call = plx.pallas_call(
            kernel, out_shape=jax.ShapeDtypeStruct(x.shape[-2:], x.dtype), interpret=True)
        return jnp.stack([call(storage, xi) for xi in x])

    @jax.custom_vjp
    def matvec(x):
        return run(bs, x)

    matvec.defvjp(lambda x: (run(bs, x), None), lambda _, g: (run(bst, g),))
    return matvec(v)


def test_pair_gradcheck():
    a, b_, xs = _pair_problem(12, 3, c=2)
    x = torch.as_tensor(xs).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda v: _pair_apply(a, b_, v, 3), (x,))


def test_pair_cpu_uses_plain_versions_and_counts_no_launch():
    a, b_, xs = _pair_problem(20, 3)
    t = torch.as_tensor
    before = dict(cb.KERNEL_LAUNCHES)
    x = t(xs).requires_grad_(True)
    ya, yb = _pair_apply(a, b_, x, 3)
    g = torch.autograd.grad((ya * 1.5 + yb * 0.5).sum(), x)[0]
    np.testing.assert_array_equal(ya.detach().numpy(), band_storage_matvec_torch(t(a[1]), t(xs), 3).numpy())
    np.testing.assert_array_equal(yb.detach().numpy(), band_storage_matvec_torch(t(b_[1]), t(xs), 3).numpy())
    want_g = band_matvec_pair_t_torch(t(a[2]), t(b_[2]), torch.full_like(x, 1.5),
                                      torch.full_like(x, 0.5), 3)
    np.testing.assert_allclose(g.numpy(), want_g.numpy(), rtol=1e-14, atol=1e-14)
    assert cb.KERNEL_LAUNCHES == before


def test_chain_axis_and_leading_axes():
    dense, bs, bst, xs = _problem(31, 4, c=5)
    bs_t, bst_t = torch.as_tensor(bs), torch.as_tensor(bst)
    batched = cb.band_matvec(bs_t, bst_t, torch.as_tensor(xs), 4)
    for c in range(5):
        one = cb.band_matvec(bs_t, bst_t, torch.as_tensor(xs[c]), 4)
        np.testing.assert_allclose(batched[c].numpy(), one.numpy(), rtol=1e-14, atol=1e-15)
    nested = cb.band_matvec(bs_t, bst_t, torch.as_tensor(xs.reshape(5, 1, 2, 31)), 4)
    np.testing.assert_allclose(nested.reshape(5, 2, 31).numpy(), batched.numpy(), rtol=1e-14)
    # a transposed (non-contiguous) input, as the likelihood passes it
    xt = torch.as_tensor(np.ascontiguousarray(xs.transpose(0, 2, 1))).transpose(-1, -2)
    np.testing.assert_allclose(cb.band_matvec(bs_t, bst_t, xt, 4).numpy(), batched.numpy())


def test_cpu_tensor_uses_twin_and_counts_no_launch():
    _, bs, bst, xs = _problem(20, 3)
    before = cb.launches()
    got = cb.band_matvec(torch.as_tensor(bs), torch.as_tensor(bst), torch.as_tensor(xs), 3)
    want = band_storage_matvec_torch(torch.as_tensor(bs), torch.as_tensor(xs), 3)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert cb.launches() == before


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    _, bs, _, xs = _problem(20, 3)
    bs, xs = torch.as_tensor(bs), torch.as_tensor(xs)
    with pytest.raises(ValueError, match="CUDA"):
        cb.band_matvec_cuda(bs, xs, 3)
    with pytest.raises(ValueError, match="CUDA"):
        cb.band_matvec_pair_cuda(bs, bs, xs, 3)
    with pytest.raises(ValueError, match="CUDA"):
        cb.band_matvec_pair_t_cuda(bs, bs, xs, xs, 3)


def test_kernel_build_is_keyed_by_source():
    path = cb.library_path()
    assert path.parent == cb.BUILD_DIR and path.suffix == ".so"
    assert "sm_90a" in " ".join(cb.NVCC_FLAGS)
    assert cb.SOURCE.exists() and cb.SOURCE.suffix == ".cu"


def test_kernel_source_agrees_with_the_wrapper():
    """The tile numbers and the row tile's chain limit the wrapper passes
    are the kernel source's."""
    src = cb.SOURCE.read_text()
    codes = dict(re.findall(r"k(ChainSmall|ChainLarge|RowSmall|RowLarge) = (\d)", src))
    assert {re.sub(r"(?<!^)([A-Z])", r"_\1", k).lower(): int(v) for k, v in codes.items()} == {
        tile: i for i, tile in enumerate(cb.TILES)}
    (row_max,) = re.findall(r"constexpr int kRowMaxChains = (\d+);", src)
    assert 2 <= cb.ROW_TILE_BELOW <= int(row_max) + 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc; run on the card")
    return torch.device("cuda")


# (C, M, b, n): the slice's shape, the filllevel-5 grid (bandsize 160), and
# edges: n < W, b = 0, n not a multiple of a tile, b > 64 with n < W
CUDA_SHAPES = [(128, 2, 40, 397), (128, 2, 160, 3169), (3, 2, 5, 7), (2, 3, 0, 130),
               (4, 2, 3, 129), (5, 2, 70, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_cuda_kernel_matches_twin(cuda_device, dtype, tol):
    """The single and paired kernels, forward and backward through
    autograd, against their plain versions; two launches each."""
    for (c, m, b, n) in CUDA_SHAPES:
        rng = np.random.default_rng(b + n)
        put = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=dtype, device=cuda_device)
        bs, bst, bs2, bst2 = (put(m, 2 * b + 1, n) for _ in range(4))
        x = put(c, m, n).requires_grad_(True)
        g, g2 = put(c, m, n), put(c, m, n)
        before = cb.launches()
        y = cb.band_matvec(bs, bst, x, b)
        (gx,) = torch.autograd.grad(y, x, g)
        torch.cuda.synchronize()
        assert cb.launches() == before + 2
        pairs = [(y, band_storage_matvec_torch(bs, x.detach(), b)),
                 (gx, band_storage_matvec_torch(bst, g, b))]
        before = dict(cb.KERNEL_LAUNCHES)
        ya, yb = cb.band_matvec_pair(bs, bst, bs2, bst2, x, b)
        (gx2,) = torch.autograd.grad((ya, yb), x, (g, g2))
        torch.cuda.synchronize()
        assert {k: cb.KERNEL_LAUNCHES[k] - before[k] for k in before} == {
            "band_matvec": 0, "band_matvec_pair": 1, "band_matvec_pair_t": 1}
        want_a, want_b = band_matvec_pair_torch(bs, bs2, x.detach(), b)
        pairs += [(ya, want_a), (yb, want_b),
                  (gx2, band_matvec_pair_t_torch(bst, bst2, g, g2, b))]
        for got, want in pairs:
            assert float((got - want).abs().max()) <= tol * float(want.abs().max()), (c, m, b, n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bandwidth", [40, 63, 64, 160])
def test_tile_for_at_the_threshold(dtype, bandwidth):
    """The row tile below ROW_TILE_BELOW chains, the chain tile from it on;
    the Large order for float32 from a band width 2b+1 of LARGE_FROM_WIDTH
    on (b = 64: 129), the Small order for float64 at every width."""
    order = ("large" if dtype == torch.float32 and 2 * bandwidth + 1 >= cb.LARGE_FROM_WIDTH
             else "small")
    assert cb.LARGE_FROM_WIDTH == 128
    below = cb.ROW_TILE_BELOW
    for chains, kind in ((1, "row"), (below - 1, "row"), (below, "chain"), (below + 1, "chain"),
                         (128, "chain")):
        tile = cb.tile_for(chains, bandwidth, dtype)
        assert tile == f"{kind}_{order}" and tile in cb.TILES, (chains, tile)
    assert (order == "large") == (dtype == torch.float32 and bandwidth >= 64)


def test_launch_counts_by_entry_point_and_tile():
    """``counts`` gives every count, ``add_launches`` (a CUDA-graph
    replay's) adds entry points and tiles, ``reset_launches`` zeroes both."""
    before = cb.counts()
    assert set(before) == set(cb.N_POINTERS) | set(cb.TILES)
    try:
        cb.add_launches({"band_matvec": 2, "band_matvec_pair": 1, "row_small": 2,
                         "chain_large": 1})
        after = cb.counts()
        assert {k: after[k] - before[k] for k in after} == {
            "band_matvec": 2, "band_matvec_pair": 1, "band_matvec_pair_t": 0,
            "chain_small": 0, "chain_large": 1, "row_small": 2, "row_large": 0}
        assert cb.launches() == sum(before[k] for k in cb.N_POINTERS) + 3
        cb.reset_launches()
        assert set(cb.counts().values()) == {0}
    finally:
        cb.reset_launches()
        cb.add_launches(before)


@lru_cache(maxsize=None)
def _jit_pallas(m, n, b):
    """The Pallas kernel in interpret mode for (m, n) storages at b,
    compiled once (the cases below share it)."""
    kernel = partial(pb._band_matvec_kernel, bandwidth=b, n=n, m=m)
    return jax.jit(plx.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((m, n), jnp.float64), interpret=True))


@pytest.mark.parametrize("n,b", [(200, 64), (100, 64)])
@pytest.mark.parametrize("chains", [1, 2, 3])
def test_few_chains_match_the_pallas_kernel(n, b, chains):
    """At the row tile's chain counts, the plain versions of the three
    entry points (the kernel's CPU path and oracle) against the JAX
    package's Pallas kernel in interpret mode, chain by chain, float64:
    b at the TPU kernel's limit, and n < 2b+1."""
    a, b_, xs = _pair_problem(n, b, c=chains)
    t = torch.as_tensor
    got_a, got_b = band_matvec_pair_torch(t(a[1]), t(b_[1]), t(xs), b)
    got_t = band_matvec_pair_t_torch(t(a[2]), t(b_[2]), t(xs), t(xs[::-1].copy()), b)
    pallas = lambda storage, x: np.asarray(_jit_pallas(*storage.shape[::2], b)(storage, x))
    want_a = np.stack([pallas(a[1], x) for x in xs])
    want_b = np.stack([pallas(b_[1], x) for x in xs])
    want_t = np.stack([pallas(a[2], x) + pallas(b_[2], v) for x, v in zip(xs, xs[::-1])])
    np.testing.assert_allclose(band_storage_matvec_torch(t(a[1]), t(xs), b).numpy(), want_a,
                               rtol=1e-12, atol=1e-12)
    for got, want in ((got_a, want_a), (got_b, want_b), (got_t, want_t)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_row_tile_keeps_every_chains_bits(cuda_device, dtype):
    """Each chain's outputs at few chains (the row tile, and the chain tile
    from the threshold on) equal its rows of one 128-chain launch, bit for
    bit, for the three entry points."""
    for (m, b, n) in [(2, 40, 397), (2, 160, 1113), (2, 5, 7), (3, 0, 130), (2, 70, 150)]:
        rng = np.random.default_rng(b + n)
        put = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=dtype, device=cuda_device)
        ba, bb, xa, xb = put(m, 2 * b + 1, n), put(m, 2 * b + 1, n), put(128, m, n), put(128, m, n)
        ops = [lambda u, v: (cb.band_matvec_cuda(ba, u, b),),
               lambda u, v: cb.band_matvec_pair_cuda(ba, bb, u, b),
               lambda u, v: (cb.band_matvec_pair_t_cuda(ba, bb, u, v, b),)]
        for op in ops:
            full = op(xa, xb)
            for c in sorted({1, 2, 3, cb.ROW_TILE_BELOW - 1, cb.ROW_TILE_BELOW}):
                idx = torch.as_tensor(np.sort(rng.choice(128, size=c, replace=False)),
                                      device=cuda_device)
                got = op(xa[idx].contiguous(), xb[idx].contiguous())
                assert all(torch.equal(u, w[idx]) for u, w in zip(got, full)), (m, b, n, c)
