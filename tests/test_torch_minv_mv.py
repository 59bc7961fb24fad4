"""PyTorch port, the dense metric's product M^-1 g (ops/minv_mv.py): the
plain version ``g @ minv.T`` (the rows of a non-symmetric M^-1) against
float64 numpy; ``DenseMetric.velocity`` takes it on the CPU and launches
nothing, and on the card takes the kernel, whose failed build raises with no
fallback; the kernel's summation order (its k split) depends on dim alone
and covers every k once, mirrored from the source; the prepared operand's
layout unpacks to minv exactly, is kept on the tensor and rewritten in
place after an in-place write; the graphed tree prepares its metric copy
when the metric changes and not otherwise; the whitening GEMMs' rule picks
the kernel exactly where it measured faster; the work its bound is
computed from; the NUTS tree's graphs count the product's launches apart
from the value-and-grad's. On a card (tests marked ``cuda``; no JAX import
here) the kernel agrees with the plain version in float64, keeps float32
error within torch.matmul's, gives a chain the same bits at any chain
count, and the preparation kernel writes its plain version's bits."""
import re

import numpy as np
import pytest
import torch

from manifold_constrained_gaussian_process_inference_tpu_torch.inference import (
    nuts_batched as nb,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.inference.nuts import DenseMetric
from manifold_constrained_gaussian_process_inference_tpu_torch.ops import cuda_band, minv_mv
from manifold_constrained_gaussian_process_inference_tpu_torch.utils import trace

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
    """The C entry points (the product on a prepared operand, the
    preparation) and the split's and the prepared layout's constants are
    the wrapper's; the source builds for sm_90a through cuda_band."""
    src = minv_mv.SOURCE.read_text()
    for suffix in ("f32", "f64"):
        assert re.search(rf"int {minv_mv.MINV_MV}_{suffix}\(const void\* prepared", src)
        assert re.search(rf"int {minv_mv.MINV_MV}_traced_{suffix}\(const void\* prepared", src)
        assert re.search(rf"int {minv_mv.PREPARE}_{suffix}\(const void\* minv, void\* prepared",
                         src)
    consts = {name: int(v) for name, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (consts["kStep"], consts["kStepsPerRange"], consts["kMaxSplit"], consts["kRows"]) == (
        minv_mv.STEP, minv_mv.STEPS_PER_RANGE, minv_mv.MAX_SPLIT, minv_mv.ROWS)
    assert "prep[rt][ks][kk][j][lane][e] = minv[32 rt + 8 j + lane / 4][32 ks + 8 kk + lane % 4" \
           " + 4 e]" in src
    assert cuda_band.library_path(minv_mv.SOURCE).parent == cuda_band.BUILD_DIR


def _unpack(prep: np.ndarray, dim: int) -> np.ndarray:
    """minv back from a prepared operand, element by element from the
    layout's definition (csrc/minv_mv.cu): block (rt, ks) of ROWS x STEP,
    B fragments (kk, j), lane = 4 (row % 8) + k % 4, e = (k % 8) // 4."""
    steps = -(-dim // minv_mv.STEP)
    out = np.full((steps * minv_mv.ROWS, steps * minv_mv.STEP), np.nan)
    p = 0
    for rt in range(steps):
        for ks in range(steps):
            for kk in range(4):
                for j in range(4):
                    for lane in range(32):
                        for e in range(2):
                            out[32 * rt + 8 * j + lane // 4, 32 * ks + 8 * kk + lane % 4 + 4 * e] \
                                = prep[p]
                            p += 1
    assert p == prep.size == minv_mv.prepared_size(dim)
    assert not np.isnan(out).any()  # every element written once
    return out


@pytest.mark.parametrize("dim", [87, 799, 1591])
def test_prepared_layout_unpacks_to_minv(dim):
    """The prepared operand (the plain version of the preparation, which
    the wrapper uses on the CPU) holds minv exactly, float64, its padding
    zero; a transposed view prepares as its contiguous copy does."""
    rng = np.random.default_rng(dim)
    minv = torch.as_tensor(rng.normal(size=(dim, dim)).astype(np.float32))
    prep = minv_mv.prepare_torch(minv)
    assert prep.dtype == torch.float64 and prep.shape == (minv_mv.prepared_size(dim),)
    full = _unpack(prep.numpy(), dim)
    assert np.array_equal(full[:dim, :dim], minv.double().numpy())
    assert not full[dim:].any() and not full[:, dim:].any()
    assert torch.equal(minv_mv.prepare(minv), prep)  # the wrapper on the CPU
    assert torch.equal(minv_mv.prepare_torch(minv.T), minv_mv.prepare_torch(minv.T.contiguous()))


def test_prepared_operand_is_kept_and_rewritten_in_place(monkeypatch):
    """``prepared`` makes the operand once per tensor, returns it while the
    tensor is unchanged, and writes it again into the same storage after an
    in-place write to minv."""
    calls = []
    real = minv_mv.prepare
    monkeypatch.setattr(minv_mv, "prepare", lambda m, out=None: calls.append(out) or real(m, out))
    minv = torch.as_tensor(_inputs(1, 40)[0])
    first = minv_mv.prepared(minv)
    assert minv_mv.prepared(minv) is first and len(calls) == 1
    minv.mul_(2.0)
    again = minv_mv.prepared(minv)
    assert again is first and calls[-1] is first and len(calls) == 2
    assert torch.equal(again, minv_mv.prepare_torch(minv))
    assert minv_mv.prepared(minv) is first and len(calls) == 2


@pytest.mark.parametrize("dims", [range(1, 700), range(700, 2600, 7)])
def test_split_covers_every_k_once(dims):
    """The kernel's ranges of k (S ranges of whole steps, from dim alone)
    cover 0..dim-1 exactly once in order, at most MAX_SPLIT of them; [slice]'s
    dim 799 takes four ranges of seven steps, config 4's 1591 four of 13."""
    for dim in dims:
        ranges, per = minv_mv.split(dim)
        assert 1 <= ranges <= minv_mv.MAX_SPLIT
        covered = [k for r in range(ranges)
                   for k in range(r * per * minv_mv.STEP, min(dim, (r + 1) * per * minv_mv.STEP))]
        assert covered == list(range(dim)), dim
    assert minv_mv.split(799) == (4, 7) and minv_mv.split(1591) == (4, 13)
    assert minv_mv.split(105) == (1, 4)


def test_product_work_counts_the_call():
    flop, nbytes = minv_mv.product_work(128, 799, 4)
    assert flop == 2 * 128 * 799 * 799 and nbytes == 4 * (799 * 799 + 2 * 128 * 799)


def test_tree_counts_the_product_apart_from_the_value_and_grad():
    """The tree's per-leaf counts hold the product beside the band kernels,
    and adding them back routes each name to its own module's count."""
    names = nb.kernel_launch_counts()
    assert minv_mv.MINV_MV in names and set(cuda_band.counts()) < set(names)
    before_p, before_b = dict(minv_mv.LAUNCHES), cuda_band.counts()
    nb.add_kernel_launches({minv_mv.MINV_MV: 3, cuda_band.CENTERED_VG: 2})
    assert minv_mv.LAUNCHES[minv_mv.MINV_MV] == before_p[minv_mv.MINV_MV] + 3
    after = cuda_band.counts()
    assert after[cuda_band.CENTERED_VG] == before_b[cuda_band.CENTERED_VG] + 2
    assert minv_mv.MINV_MV not in after
    nb.add_kernel_launches({minv_mv.MINV_MV: -3, cuda_band.CENTERED_VG: -2})


def test_tree_prepares_the_metric_when_it_changes(monkeypatch):
    """The graphed tree's ``_bind`` copies a dense metric into its own
    buffers and writes the product's prepared operand of that copy in
    place (the graphs read both by address): one preparation per bind,
    whatever the caller's metric. Between binds the copy is unchanged, so
    the leaves' products (``prepared``) do not prepare it again. (The
    binding itself runs on CPU tensors here.)"""
    calls = []
    real = minv_mv.prepare
    monkeypatch.setattr(minv_mv, "prepare", lambda m, out=None: calls.append(out) or real(m, out))
    tree = nb.LockstepTree(lambda q: None, torch.Generator(), max_depth=3, graphed=True)
    minv, _ = (torch.as_tensor(x) for x in _inputs(2, 9))
    q = torch.zeros(2, 9, dtype=torch.float64)
    metric = DenseMetric(minv, minv.clone(), minv.clone())
    bound = tree._bind(q, 0.1, metric)
    assert bound is tree.metric and bound.minv is not minv and torch.equal(bound.minv, minv)
    prep = minv_mv.prepared(bound.minv)
    assert len(calls) == 1 and torch.equal(prep, minv_mv.prepare_torch(minv))
    assert minv_mv.prepared(bound.minv) is prep and len(calls) == 1  # the same copy: kept

    assert tree._bind(q, 0.2, metric) is bound  # the same metric: copied, prepared in place
    assert len(calls) == 2 and calls[-1] is prep and minv_mv.prepared(bound.minv) is prep

    changed = DenseMetric(2 * minv, minv.clone(), minv.clone())  # a new metric
    assert tree._bind(q, 0.2, changed) is bound
    assert len(calls) == 3 and calls[-1] is prep  # written in place
    assert minv_mv.prepared(bound.minv) is prep and len(calls) == 3
    assert torch.equal(bound.minv, 2 * minv)
    assert torch.equal(prep, minv_mv.prepare_torch(2 * minv))

    changed.minv.add_(1.0)  # the same tensors, written since
    tree._bind(q, 0.2, changed)
    assert len(calls) == 4
    assert torch.equal(prep, minv_mv.prepare_torch(2 * minv + 1.0))


def test_eager_tree_binds_the_callers_metric():
    tree = nb.LockstepTree(lambda q: None, torch.Generator(), max_depth=3, graphed=False)
    minv = torch.as_tensor(_inputs(1, 9)[0])
    metric = DenseMetric(minv, minv, minv)
    assert tree._bind(torch.zeros(1, 9, dtype=torch.float64), 0.1, metric) is metric
    assert tree.metric is None  # no copy, nothing prepared


# (C, dim, kernel ms, torch.matmul ms) of the product at the whitening
# GEMMs' shapes on the H100, float32 (perf/product_timing.py, PERF.md)
MEASURED = [(128, 799, 0.0099, 0.0123), (64, 799, 0.0078, 0.0111), (32, 799, 0.0077, 0.0090),
            (3, 799, 0.0053, 0.0060), (1, 799, 0.0053, 0.0030), (128, 1591, 0.0250, 0.0232),
            (64, 1591, 0.0157, 0.0163), (32, 1591, 0.0124, 0.0162), (3, 1591, 0.0090, 0.0111),
            (1, 1591, 0.0089, 0.0049), (128, 87, 0.0056, 0.0070), (64, 87, 0.0039, 0.0067),
            (32, 87, 0.0035, 0.0067), (3, 87, 0.00252, 0.00239), (1, 87, 0.00252, 0.00212)]


@pytest.mark.parametrize("c, dim, kernel_ms, matmul_ms", MEASURED)
def test_whitening_gemm_rule_picks_the_faster(c, dim, kernel_ms, matmul_ms):
    from manifold_constrained_gaussian_process_inference_tpu_torch.ops import centered_vg

    assert centered_vg.gemm_takes_kernel(c, dim) == (kernel_ms < matmul_ms)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc; run on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("c, dim", [(128, 799), (32, 799), (3, 87), (1, 799), (1, 1591),
                                    (128, 1591)])
def test_cuda_product_matches_the_plain_version(cuda_device, c, dim):
    """float64 to 1e-14 of the largest output; float32 no further from the
    float64 product than torch.matmul's float32 product; one launch; the
    traced launch's bits are the same, and it stamps its stage."""
    minv, g = _inputs(c, dim, seed=dim)
    want = torch.as_tensor(g) @ torch.as_tensor(minv).T
    for dtype in (torch.float64, torch.float32):
        m, x = (torch.as_tensor(a, dtype=dtype, device=cuda_device) for a in (minv, g))
        before = minv_mv.LAUNCHES[minv_mv.MINV_MV]
        got = minv_mv.minv_mv(m, x).cpu().double()
        assert minv_mv.LAUNCHES[minv_mv.MINV_MV] == before + 1
        # the traced entry point (a stamp buffer, utils/trace.py) writes the same bits
        stamps = torch.zeros(trace.STAMP_WORDS, dtype=torch.int64, device=cuda_device)
        for prev, stage in ((trace.BETWEEN, trace.VG), (trace.VG, trace.METRIC)):
            stamped = minv_mv.product(minv_mv.prepared(m), x,
                                      stamp=(stamps.data_ptr(), prev, stage))
            assert torch.equal(stamped.cpu().double(), got)
        hits = stamps[trace.SUMS + len(trace.STAGES):].tolist()
        assert hits[trace.BETWEEN] == hits[trace.VG] == 1
        assert stamps[trace.CURRENT] == trace.METRIC
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


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [87, 799, 1591])
def test_cuda_preparation_matches_its_plain_version(cuda_device, dim):
    """The preparation kernel writes the plain version's layout bit for bit,
    of a row-major minv and of a transposed view; one launch each."""
    minv, _ = _inputs(1, dim, seed=dim)
    for dtype in (torch.float32, torch.float64):
        m = torch.as_tensor(minv, dtype=dtype, device=cuda_device)
        for view in (m, m.T):
            before = minv_mv.LAUNCHES[minv_mv.PREPARE]
            assert torch.equal(minv_mv.prepare(view), minv_mv.prepare_torch(view))
            assert minv_mv.LAUNCHES[minv_mv.PREPARE] == before + 1
