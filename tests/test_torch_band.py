"""PyTorch port, band storage: the band matvec against three references
(the JAX package's XLA band_matvec, the Pallas kernel in interpret mode as
tests/test_band_impl.py runs it, and the dense einsum), forward and
autograd backward, with the chain axis and the edge shapes. On a CPU tensor
the wrapper runs the plain twin; the kernel itself is checked against the
twin by the test marked ``cuda``, which runs on the card only."""
from functools import partial

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
    want_xla = np.stack([
        np.asarray(pb.band_matvec(jnp.asarray(bs), jnp.asarray(bst), jnp.asarray(x), b, False))
        for x in xs
    ])
    kernel = partial(pb._band_matvec_kernel, bandwidth=b, n=n, m=bs.shape[0])
    want_pallas = np.stack([
        np.asarray(plx.pallas_call(
            kernel, out_shape=jax.ShapeDtypeStruct((bs.shape[0], n), jnp.float64),
            interpret=True,
        )(jnp.asarray(bs), jnp.asarray(x)))
        for x in xs
    ])
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
    before = cb.LAUNCHES
    got = cb.band_matvec(torch.as_tensor(bs), torch.as_tensor(bst), torch.as_tensor(xs), 3)
    want = band_storage_matvec_torch(torch.as_tensor(bs), torch.as_tensor(xs), 3)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert cb.LAUNCHES == before


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    _, bs, _, xs = _problem(20, 3)
    with pytest.raises(ValueError, match="CUDA"):
        cb.band_matvec_cuda(torch.as_tensor(bs), torch.as_tensor(xs), 3)


def test_kernel_build_is_keyed_by_source():
    path = cb.library_path()
    assert path.parent == cb.BUILD_DIR and path.suffix == ".so"
    assert "sm_90a" in " ".join(cb.NVCC_FLAGS)
    assert cb.SOURCE.exists() and cb.SOURCE.suffix == ".cu"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc; run on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_cuda_kernel_matches_twin(cuda_device, dtype, tol):
    for (c, m, b, n) in [(128, 2, 40, 397), (3, 2, 5, 7), (2, 3, 0, 130), (4, 2, 3, 129)]:
        rng = np.random.default_rng(b + n)
        put = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda_device)
        bs, bst = put(rng.normal(size=(m, 2 * b + 1, n))), put(rng.normal(size=(m, 2 * b + 1, n)))
        x = put(rng.normal(size=(c, m, n))).requires_grad_(True)
        g = put(rng.normal(size=(c, m, n)))
        before = cb.LAUNCHES
        y = cb.band_matvec(bs, bst, x, b)
        (gx,) = torch.autograd.grad(y, x, g)
        torch.cuda.synchronize()
        assert cb.LAUNCHES == before + 2
        for got, want in ((y, band_storage_matvec_torch(bs, x.detach(), b)),
                          (gx, band_storage_matvec_torch(bst, g, b))):
            assert float((got - want).abs().max()) <= tol * float(want.abs().max())
