"""PyTorch port, the dense metric's product M^-1 g (ops/minv_mv.py): the
plain version ``g @ minv.T`` (the rows of a non-symmetric M^-1) against
float64 numpy; ``DenseMetric.velocity`` takes it on the CPU and launches
nothing, and on the card takes the kernel, whose failed build raises with no
fallback; the kernel's summation order (its k split) depends on dim alone
and covers every k once, mirrored from the source; the work its bound is
computed from; the NUTS tree's graphs count the product's launches apart
from the value-and-grad's. On a card (tests marked ``cuda``; no JAX import
here) the kernel agrees with the plain version in float64, keeps float32
error within torch.matmul's, and gives a chain the same bits at any chain
count."""
import re

import numpy as np
import pytest
import torch

from manifold_constrained_gaussian_process_inference_tpu_torch.inference import (
    nuts_batched as nb,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.inference.nuts import DenseMetric
from manifold_constrained_gaussian_process_inference_tpu_torch.ops import cuda_band, minv_mv

torch.set_num_threads(1)

SHAPES = [(1, 9), (6, 9), (5, 31), (3, 130), (128, 41)]


def _inputs(c, dim, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(dim, dim)) + 3 * np.eye(dim), rng.normal(size=(c, dim))


@pytest.mark.parametrize("c, dim", SHAPES)
def test_plain_product_takes_the_rows_of_minv(c, dim):
    minv, g = _inputs(c, dim, seed=c + dim)
    got = minv_mv.minv_mv_torch(torch.as_tensor(minv), torch.as_tensor(g)).numpy()
    want = np.einsum("ik,ck->ci", minv, g)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
    assert not np.allclose(got, g @ minv, rtol=1e-6)


def test_dense_velocity_runs_the_plain_product_on_the_cpu(monkeypatch):
    """On CPU tensors ``DenseMetric.velocity`` is the plain product, bit for
    bit, in any leading shape, and never the kernel's wrapper."""
    def never(*args, **kwargs):
        raise AssertionError("the kernel's wrapper ran on CPU tensors")

    monkeypatch.setattr(minv_mv, "minv_mv_cuda", never)
    minv, g = (torch.as_tensor(x) for x in _inputs(4, 11))
    before = dict(minv_mv.LAUNCHES)
    metric = DenseMetric(minv, minv, minv)
    assert torch.equal(metric.velocity(g), minv_mv.minv_mv_torch(minv, g))
    assert torch.equal(metric.velocity(g[1]), g[1] @ minv.T)
    assert minv_mv.LAUNCHES == before
    with pytest.raises(ValueError, match="unsupported device"):
        minv_mv._on_card(torch.zeros(1, device="meta"))


def test_card_branch_raises_when_the_kernel_cannot_build(monkeypatch):
    """The card branch, reached through its device predicate, raises the
    build's error: no fallback to the plain product, nothing counted."""
    def failed_build(source):
        raise RuntimeError(f"nvcc failed to build {source.name}")

    monkeypatch.setattr(minv_mv, "_on_card", lambda t: True)
    monkeypatch.setattr(minv_mv, "_LIB", None)
    monkeypatch.setattr(cuda_band, "build", failed_build)
    minv, g = (torch.as_tensor(x) for x in _inputs(3, 7))
    before = dict(minv_mv.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc failed to build minv_mv.cu"):
        DenseMetric(minv, minv, minv).velocity(g)
    assert minv_mv.LAUNCHES == before


def test_kernel_source_agrees_with_the_wrapper():
    """The C entry points and the split's constants are the wrapper's; the
    source builds for sm_90a through cuda_band."""
    src = minv_mv.SOURCE.read_text()
    for suffix in ("f32", "f64"):
        assert re.search(rf"int {minv_mv.MINV_MV}_{suffix}\(const void\* minv", src)
    consts = {name: int(v) for name, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (consts["kStep"], consts["kStepsPerRange"], consts["kMaxSplit"]) == (
        minv_mv.STEP, minv_mv.STEPS_PER_RANGE, minv_mv.MAX_SPLIT)
    assert cuda_band.library_path(minv_mv.SOURCE).parent == cuda_band.BUILD_DIR


@pytest.mark.parametrize("dims", [range(1, 700), range(700, 2600, 7)])
def test_split_covers_every_k_once(dims):
    """The kernel's ranges of k (S ranges of whole steps, from dim alone)
    cover 0..dim-1 exactly once in order, at most MAX_SPLIT of them; [slice]'s
    dim 799 takes five ranges of five steps."""
    for dim in dims:
        ranges, per = minv_mv.split(dim)
        assert 1 <= ranges <= minv_mv.MAX_SPLIT
        covered = [k for r in range(ranges)
                   for k in range(r * per * minv_mv.STEP, min(dim, (r + 1) * per * minv_mv.STEP))]
        assert covered == list(range(dim)), dim
    assert minv_mv.split(799) == (5, 5) and minv_mv.split(105) == (1, 4)


def test_product_work_counts_the_call():
    flop, nbytes = minv_mv.product_work(128, 799, 4)
    assert flop == 2 * 128 * 799 * 799 and nbytes == 4 * (799 * 799 + 2 * 128 * 799)


def test_tree_counts_the_product_apart_from_the_value_and_grad():
    """The tree's per-leaf counts hold the product beside the band kernels,
    and adding them back routes each name to its own module's count."""
    names = nb._per_leaf_counts()
    assert minv_mv.MINV_MV in names and set(cuda_band.counts()) < set(names)
    before_p, before_b = dict(minv_mv.LAUNCHES), cuda_band.counts()
    nb._add_per_leaf({minv_mv.MINV_MV: 3, cuda_band.CENTERED_VG: 2})
    assert minv_mv.LAUNCHES[minv_mv.MINV_MV] == before_p[minv_mv.MINV_MV] + 3
    after = cuda_band.counts()
    assert after[cuda_band.CENTERED_VG] == before_b[cuda_band.CENTERED_VG] + 2
    assert minv_mv.MINV_MV not in after
    nb._add_per_leaf({minv_mv.MINV_MV: -3, cuda_band.CENTERED_VG: -2})


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc; run on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("c, dim", [(128, 799), (32, 799), (3, 87), (1, 1591)])
def test_cuda_product_matches_the_plain_version(cuda_device, c, dim):
    """float64 to 1e-14 of the largest output; float32 no further from the
    float64 product than torch.matmul's float32 product; one launch."""
    minv, g = _inputs(c, dim, seed=dim)
    want = torch.as_tensor(g) @ torch.as_tensor(minv).T
    for dtype in (torch.float64, torch.float32):
        m, x = (torch.as_tensor(a, dtype=dtype, device=cuda_device) for a in (minv, g))
        before = minv_mv.LAUNCHES[minv_mv.MINV_MV]
        got = minv_mv.minv_mv(m, x).cpu().double()
        assert minv_mv.LAUNCHES[minv_mv.MINV_MV] == before + 1
        err = float((got - want).abs().max())
        if dtype == torch.float64:
            assert err <= 1e-14 * float(want.abs().max())
        else:
            assert err <= float(((x @ m.T).cpu().double() - want).abs().max())


@pytest.mark.cuda
def test_cuda_product_chain_bits_do_not_depend_on_the_batch(cuda_device):
    minv, g = _inputs(128, 799, seed=1)
    for dtype in (torch.float32, torch.float64):
        m, x = (torch.as_tensor(a, dtype=dtype, device=cuda_device) for a in (minv, g))
        full = minv_mv.minv_mv(m, x)
        for idx in ([5], [7, 8, 9], list(range(32, 64))):
            assert torch.equal(minv_mv.minv_mv(m, x[idx]), full[idx])
