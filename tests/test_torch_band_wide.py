"""PyTorch port, band storage above the TPU kernel's bandwidth limit of 64
(which the CUDA kernel does not have): the single and paired band matvecs
at n = 150, b = 70 against the dense einsum, the JAX package's XLA
band_matvec and its Pallas kernel in interpret mode, forward and autograd
backward, float64. The JAX references run on the first chain only: each
of the 141 diagonal shifts compiles once on the CPU."""
from functools import partial

import jax
import jax.experimental.pallas as plx
import jax.numpy as jnp
import numpy as np
import torch

import manifold_constrained_gaussian_process_inference_tpu.ops.pallas_band as pb
from manifold_constrained_gaussian_process_inference_tpu.ops.band import (
    dense_to_band_storage,
    mat2band,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.ops import cuda_band as cb

torch.set_num_threads(1)
N, B, M, C = 150, 70, 2, 3


def _stack(seed):
    rng = np.random.default_rng(seed)
    dense = np.stack([mat2band(rng.normal(size=(N, N)), B, B) for _ in range(M)])
    bs = np.stack([dense_to_band_storage(a, B) for a in dense])
    bst = np.stack([pb.transpose_band_storage(s, B) for s in bs])
    return dense, bs, bst


def _pallas(storage, x):
    kernel = partial(pb._band_matvec_kernel, bandwidth=B, n=N, m=M)
    return plx.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((M, N), jnp.float64), interpret=True,
    )(storage, x)


def _pallas_matvec(bs, bst):
    """The JAX package's band matvec with the Pallas kernel in interpret
    mode on both passes (backward on the transposed storage)."""

    @jax.custom_vjp
    def matvec(x):
        return _pallas(bs, x)

    matvec.defvjp(lambda x: (_pallas(bs, x), None), lambda _, g: (_pallas(bst, g),))
    return matvec


def test_wide_band_forward_matches_jax():
    (da, bsa, bsta), (db, bsb, bstb) = _stack(0), _stack(1)
    xs = np.random.default_rng(2).normal(size=(C, M, N))
    t = torch.as_tensor
    single = cb.band_matvec(t(bsa), t(bsta), t(xs), B)
    ya, yb = cb.band_matvec_pair(t(bsa), t(bsta), t(bsb), t(bstb), t(xs), B)
    np.testing.assert_array_equal(single.numpy(), ya.numpy())
    for got, (dense, bs, bst) in ((ya, (da, bsa, bsta)), (yb, (db, bsb, bstb))):
        np.testing.assert_allclose(got.numpy(), np.einsum("mij,cmj->cmi", dense, xs),
                                   rtol=1e-12, atol=1e-12)
        want_xla = pb.band_matvec(jnp.asarray(bs), jnp.asarray(bst), jnp.asarray(xs[0]), B, False)
        want_pallas = _pallas(jnp.asarray(bs), jnp.asarray(xs[0]))
        for want in (want_xla, want_pallas):
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


def test_wide_band_backward_matches_jax_vjp():
    """d/dx of sum(sin(A x) + cos(B x) * A x): the paired op's backward (one
    call for A^T g_a + B^T g_b) against the JAX package's custom VJP on its
    XLA path and on the Pallas kernel in interpret mode, and the dense
    VJP."""
    (da, bsa, bsta), (db, bsb, bstb) = _stack(3), _stack(4)
    xs = np.random.default_rng(5).normal(size=(1, M, N))
    t = torch.as_tensor
    x = t(xs).requires_grad_(True)
    ya, yb = cb.band_matvec_pair(t(bsa), t(bsta), t(bsb), t(bstb), x, B)
    val = torch.sum(torch.sin(ya)) + torch.sum(torch.cos(yb) * ya)
    (g_t,) = torch.autograd.grad(val, x)
    ja, jb = (np.einsum("mij,mj->mi", d, xs[0]) for d in (da, db))
    g_dense = (np.einsum("mij,mi->mj", da, np.cos(ja) + np.cos(jb))
               - np.einsum("mij,mi->mj", db, np.sin(jb) * ja))
    np.testing.assert_allclose(g_t[0].numpy(), g_dense, rtol=1e-11, atol=1e-12)

    j = [jnp.asarray(a) for a in (bsa, bsta, bsb, bstb)]
    references = (
        (lambda v: pb.band_matvec(j[0], j[1], v, B, False),
         lambda v: pb.band_matvec(j[2], j[3], v, B, False)),
        (_pallas_matvec(j[0], j[1]), _pallas_matvec(j[2], j[3])),
    )
    for mv_a, mv_b in references:
        f = lambda v: jnp.sum(jnp.sin(mv_a(v))) + jnp.sum(jnp.cos(mv_b(v)) * mv_a(v))
        v_j, g_j = jax.value_and_grad(f)(jnp.asarray(xs[0]))
        np.testing.assert_allclose(float(val.detach()), float(v_j), rtol=1e-12)
        np.testing.assert_allclose(g_t[0].numpy(), np.asarray(g_j), rtol=1e-12, atol=1e-12)
