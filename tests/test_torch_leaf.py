"""PyTorch port, the NUTS leaf (ops/leaf.py): the plain versions of the two
leaf kernels, ``leaf_drift_torch`` and ``leaf_commit_torch``, held against
the JAX package's leaf pieces (``_leapfrog_b``, ``_rowdot``,
``_is_iterative_turning_b``, ``_row_update``) composed as the body of
``_build_subtree_b`` composes them, on the same inputs, over every leaf of a
depth-4 sub-tree, in float64 to rtol 1e-12: dense, shared-diagonal,
per-chain-diagonal and per-rung metrics, mixed alive masks, a divergent and
a NaN leaf, ``track_div_leaf`` on and off. The uniform of each leaf is given
to both (the JAX body draws its own from the chains' keys). On the CPU the
dispatch runs the plain versions and launches nothing; its card branch
raises, and does not fall back, when the kernels cannot be built. The drift
runs once a doubling, in its opening (leaf 0's position): each commit writes
the next leaf's position, which is the drift of the committed state bit for
bit, for every chain. With the
pair counter the plain commit is the card's: the leaf index from the
counter, which odd leaves advance while setting the leaf loop's condition;
the kernel's row arithmetic gives the checkpoint rows of every leaf. The
dense metric's product is the JAX package's ``_minv_mv_b``. On a card
(tests marked ``cuda``) the kernels agree with the plain versions."""
import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manifold_constrained_gaussian_process_inference_tpu.inference import nuts as jn
from manifold_constrained_gaussian_process_inference_tpu.inference import nuts_batched as jnb
from manifold_constrained_gaussian_process_inference_tpu_torch.inference.nuts import (
    MAX_DELTA_ENERGY,
    DenseMetric,
    DiagMetric,
    RungDenseMetric,
    _leaf_idx_to_ckpt_idxs,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.ops import cuda_band
from manifold_constrained_gaussian_process_inference_tpu_torch.ops import leaf
from manifold_constrained_gaussian_process_inference_tpu_torch.utils import trace

torch.set_num_threads(1)

C, DIM, RUNGS, DEPTH = 6, 9, 3, 4
N_LEAVES = 1 << DEPTH
CKPT_ROWS = DEPTH  # the port's rows: max(max_depth - 1, 1) at max_depth 5
JAX_ROWS = DEPTH + 1  # the JAX package's (C, max_depth, dim) buffers
RTOL = 1e-12
EPS = np.array([0.9, 0.02, 0.03, -0.04, 0.5, -0.03])
NAN_CHAIN, NAN_FROM = 5, 4  # chain 5's leaves from the 5th on have a NaN log-density
BAD_CHAIN, BAD_FROM = 2, 6  # chain 2's from the 7th on diverge
METRICS = ("dense", "shared", "diag", "rung")


def _make_vg(scale):
    """(C, dim) numpy -> (logp, grad), with the NaN and the divergent leaves
    counted per call (each side calls it once per leaf, in order)."""
    calls = [0]

    def vg(q):
        lp = -0.5 * (scale * q * q).sum(-1) + 0.1 * np.sin(q).sum(-1)
        g = -scale * q + 0.1 * np.cos(q)
        if calls[0] >= NAN_FROM:
            lp[NAN_CHAIN] = np.nan
        if calls[0] >= BAD_FROM:
            lp[BAD_CHAIN] -= 5.0 * MAX_DELTA_ENERGY
        calls[0] += 1
        return lp, g

    return vg


class _RungProduct:
    """The per-rung metric on the JAX side: chain c on rung c mod K, each
    rung's M^-1 g through the JAX package's ``_minv_mv_b``."""

    def __init__(self, minv):
        self.minv = minv

    def __rmul__(self, p):
        out = jnp.zeros_like(p)
        for k in range(RUNGS):
            out = out.at[k::RUNGS].set(jnb._minv_mv_b(jn.DenseMetric(self.minv[k], self.minv[k]),
                                                      p[k::RUNGS]))
        return out

    __mul__ = __rmul__


def _case(kind, rng):
    """(torch metric, the JAX package's inv_mass) of one kind."""
    if kind == "dense":
        a = rng.normal(size=(DIM, DIM)) * 0.2
        m = a @ a.T + np.eye(DIM)
        return DenseMetric(*(torch.as_tensor(x) for x in (m, m, m))), jn.DenseMetric(
            jnp.asarray(m), jnp.asarray(m))
    if kind == "rung":
        a = rng.normal(size=(RUNGS, DIM, DIM)) * 0.2
        m = a @ a.transpose(0, 2, 1) + np.eye(DIM)
        return RungDenseMetric(*(torch.as_tensor(m) for _ in range(3))), _RungProduct(
            jnp.asarray(m))
    shape = (DIM,) if kind == "shared" else (C, DIM)
    d = rng.uniform(0.5, 2.0, size=shape)
    return DiagMetric(torch.as_tensor(d)), jnp.asarray(d)


def _start(rng, inv_mass_j, vg):
    """A sub-tree's start, the same for both: (q, p, v, grad, mgrad) with v
    and mgrad the metric's products, chain 1 not alive."""
    q = rng.normal(size=(C, DIM))
    p = rng.normal(size=(C, DIM))
    g = vg(q)[1]
    v = np.array(jnb._minv_mv_b(inv_mass_j, jnp.asarray(p)))
    mg = np.array(jnb._minv_mv_b(inv_mass_j, jnp.asarray(g)))
    alive = np.ones(C, bool)
    alive[1] = False
    h0 = -(-0.5 * (q * q).sum(-1)) + 0.5 * (p * v).sum(-1)
    return q, p, v, g, mg, alive, h0


def _jax_subtree(start, vg, inv_mass_j, u, track):
    """Every leaf of the sub-tree through the JAX package's pieces, composed
    as the body of ``_build_subtree_b`` composes them (the uniforms given);
    the state after each leaf."""
    q, p, v, g, mg, alive, h0 = (jnp.asarray(x) for x in start)
    kdiv = DIM if track else 0
    z = jnp.zeros((C, DIM))
    s = dict(alive=alive, q=q, p=p, v=v, mgrad=mg, grad=g, q_first=q, p_first=p, v_first=v,
             grad_first=g, rho=z, q_prop=q, logp_prop=jnp.zeros(C), grad_prop=g,
             log_sum_w=jnp.full(C, -jnp.inf), sum_accept=jnp.zeros(C), n_leaves=jnp.zeros(C),
             diverging=jnp.zeros(C, bool), turning=jnp.zeros(C, bool),
             r_ckpts=jnp.zeros((C, JAX_ROWS, DIM)), v_ckpts=jnp.zeros((C, JAX_ROWS, DIM)),
             rho_ckpts=jnp.zeros((C, JAX_ROWS, DIM)), q_div=jnp.zeros((C, kdiv)),
             q_div_leaf=jnp.zeros((C, kdiv)))

    def vg_b(qq):
        lp, gg = vg(np.asarray(qq))
        return jnp.asarray(lp), jnp.asarray(gg)

    eps = jnp.asarray(EPS)
    out = []
    for j in range(N_LEAVES):
        alive = s["alive"]
        q_n, p_n, v_n, mgrad_n, logp_n, grad_n = jnb._leapfrog_b(
            vg_b, s["q"], s["p"], s["v"], s["mgrad"], s["grad"], eps, inv_mass_j)
        delta = -logp_n + 0.5 * jnb._rowdot(p_n, v_n) - h0
        bad = ~(delta <= MAX_DELTA_ENERGY)
        w = jnp.where(bad, -jnp.inf, -delta)
        accept = jnp.where(bad, 0.0, jnp.exp(jnp.minimum(0.0, -delta)))
        log_sum_w = jnp.logaddexp(s["log_sum_w"], w)
        take = alive & (jnp.asarray(u[j]) < jnp.exp(w - log_sum_w))
        take_col, alive_col = take[:, None], alive[:, None]
        rho = jnp.where(alive_col, s["rho"] + p_n, s["rho"])
        first = alive_col & (j == 0)
        idx_min, idx_max = jn._leaf_idx_to_ckpt_idxs(jnp.int32(j))
        write = alive & (j % 2 == 0)
        r_ckpts = jnb._row_update(s["r_ckpts"], p_n, idx_max, write)
        v_ckpts = jnb._row_update(s["v_ckpts"], v_n, idx_max, write)
        rho_ckpts = jnb._row_update(s["rho_ckpts"], rho, idx_max, write)
        turned = jnp.zeros(C, bool) if j % 2 == 0 else jnb._is_iterative_turning_b(
            p_n, v_n, rho, r_ckpts, v_ckpts, rho_ckpts, idx_min, idx_max)
        newly_bad = (alive & bad)[:, None]
        s = dict(
            alive=alive & ~(bad | turned),
            q=jnp.where(alive_col, q_n, s["q"]), p=jnp.where(alive_col, p_n, s["p"]),
            v=jnp.where(alive_col, v_n, s["v"]), mgrad=jnp.where(alive_col, mgrad_n, s["mgrad"]),
            grad=jnp.where(alive_col, grad_n, s["grad"]),
            q_first=jnp.where(first, q_n, s["q_first"]), p_first=jnp.where(first, p_n, s["p_first"]),
            v_first=jnp.where(first, v_n, s["v_first"]),
            grad_first=jnp.where(first, grad_n, s["grad_first"]), rho=rho,
            q_prop=jnp.where(take_col, q_n, s["q_prop"]),
            logp_prop=jnp.where(take, logp_n, s["logp_prop"]),
            grad_prop=jnp.where(take_col, grad_n, s["grad_prop"]),
            log_sum_w=jnp.where(alive, log_sum_w, s["log_sum_w"]),
            sum_accept=jnp.where(alive, s["sum_accept"] + accept, s["sum_accept"]),
            n_leaves=s["n_leaves"] + alive.astype(s["n_leaves"].dtype),
            diverging=jnp.where(alive, s["diverging"] | bad, s["diverging"]),
            turning=jnp.where(alive, turned, s["turning"]),
            r_ckpts=r_ckpts, v_ckpts=v_ckpts, rho_ckpts=rho_ckpts,
            q_div=jnp.where(newly_bad, s["q"][:, :kdiv], s["q_div"]),
            q_div_leaf=jnp.where(newly_bad, q_n[:, :kdiv], s["q_div_leaf"]),
        )
        out.append({k: np.asarray(x) for k, x in s.items()})
    return out


def _torch_state(start, track):
    """The tree's sub-tree buffers as ``LockstepTree._doubling`` starts them."""
    q, p, v, g, mg, alive, h0 = (torch.as_tensor(x) for x in start)
    cur = torch.stack([q, p, v, g, mg], dim=1)
    f = dict(dtype=torch.float64)
    st = SimpleNamespace(
        cur=cur.clone(), s_prop=cur.clone(), s_rho=torch.zeros(C, DIM, **f),
        s_logp_prop=torch.zeros(C, **f), s_sum_accept=torch.zeros(C, **f),
        s_n_leaves=torch.zeros(C, **f), s_lsw=torch.full((C,), -torch.inf, **f),
        s_div=torch.zeros(C, dtype=torch.bool), s_turn=torch.zeros(C, dtype=torch.bool),
        alive=alive.clone(), h0=h0, ckpts=torch.zeros(C, CKPT_ROWS, 3, DIM, **f),
        q=torch.zeros(2, C, DIM, **f))
    if track:
        st.s_div_edge, st.s_div_leaf = torch.zeros(C, DIM, **f), torch.zeros(C, DIM, **f)
    return st


def _steps():
    eps = torch.as_tensor(EPS)
    return (0.5 * eps)[:, None], eps[:, None]


def _tree_state(start, track):
    """``_torch_state`` with the trajectory's buffers around it, as the tree
    holds them: both edges and the proposal at the sub-tree's start, done
    where the chain is not alive, the step sizes ``EPS``; a doubling opened
    on it with u[0] < 0.5 (to the right) gives back ``_torch_state``'s
    sub-tree and ``_steps()``."""
    st = _torch_state(start, track)
    f = dict(dtype=torch.float64)
    st.left, st.right, st.prop = st.cur.clone(), st.cur.clone(), st.cur.clone()
    st.rho = torch.as_tensor(start[1]).clone()
    st.logp_prop, st.log_sum_w, st.sum_accept, st.num_leaves = (torch.zeros(C, **f)
                                                                for _ in range(4))
    st.diverging, st.done = torch.zeros(C, dtype=torch.bool), ~st.alive
    st.depth = torch.zeros(C, dtype=torch.int32)
    st.eps, st.half, st.step = torch.as_tensor(EPS), torch.zeros(C, **f), torch.zeros(C, **f)
    st.readout = torch.zeros(2, dtype=torch.int64)
    if track:
        st.div_edge, st.div_leaf = torch.zeros(C, DIM, **f), torch.zeros(C, DIM, **f)
    return st


def _to_the_right():
    """A doubling's uniforms (2, C): every chain to the right, u[1] spread."""
    return torch.stack([torch.full((C,), 0.25, dtype=torch.float64),
                        torch.linspace(0.05, 0.95, C, dtype=torch.float64)])


def _torch_leaf(st, metric, vg, u_leaf, j, track, host_j=None):
    """One leaf through the port's dispatch, as ``LockstepTree._leaf``: the
    value-and-grad at ``st.q[j % 2]`` (leaf 0's written by the plain
    drift, as the doubling's opening writes it), the commit (given
    ``host_j``, j by default) writing the next leaf's position into the
    other buffer."""
    half, step = _steps()
    q_n, q_next = st.q[j % 2], st.q[1 - j % 2]
    if j == 0:
        leaf.leaf_drift_torch(st.cur, half, step, out=q_n)
    lp, g = (torch.as_tensor(x) for x in vg(q_n.numpy()))
    j = j if host_j is None else host_j
    leaf.leaf_commit(st, metric, half, step, q_n, q_next, lp, g, u_leaf, j,
                     _leaf_idx_to_ckpt_idxs(j), MAX_DELTA_ENERGY, track)


def _close(got, want, what):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    scale = max(1.0, float(np.nanmax(np.abs(np.where(np.isfinite(want), want, 0.0)))))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale, err_msg=what)


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("kind", METRICS)
def test_plain_leaf_matches_the_jax_body(kind, track):
    rng = np.random.default_rng(METRICS.index(kind) + 10 * track)
    scale = rng.uniform(0.5, 2.0, size=DIM)
    metric, inv_mass_j = _case(kind, rng)
    start = _start(rng, inv_mass_j, _make_vg(scale))
    u = rng.random((N_LEAVES, C))
    want = _jax_subtree(start, _make_vg(scale), inv_mass_j, u, track)
    st = _torch_state(start, track)
    vg, u_leaf = _make_vg(scale), torch.as_tensor(u)
    launches = dict(leaf.LAUNCHES)
    seen = dict(take=False, bad=False, turned=False, nan=False)
    for j in range(N_LEAVES):
        prop_before = st.s_logp_prop.clone()
        _torch_leaf(st, metric, vg, u_leaf, j, track)
        w = want[j]
        what = f"{kind} track={track} leaf {j}"
        for name, row in (("q", 0), ("p", 1), ("v", 2), ("grad", 3), ("mgrad", 4)):
            _close(st.cur[:, row], w[name], f"{what}: cur {name}")
        _close(st.s_prop[:, 0], w["q_prop"], f"{what}: q_prop")
        _close(st.s_prop[:, 3], w["grad_prop"], f"{what}: grad_prop")
        for name, got in (("logp_prop", st.s_logp_prop), ("rho", st.s_rho),
                          ("log_sum_w", st.s_lsw), ("sum_accept", st.s_sum_accept),
                          ("n_leaves", st.s_n_leaves)):
            _close(got, w[name], f"{what}: {name}")
        for r, name in enumerate(("r_ckpts", "v_ckpts", "rho_ckpts")):
            _close(st.ckpts[:, :, r], w[name][:, :CKPT_ROWS], f"{what}: {name}")
        assert not w["r_ckpts"][:, CKPT_ROWS:].any()
        for name, got in (("alive", st.alive), ("diverging", st.s_div), ("turning", st.s_turn)):
            assert np.array_equal(got.numpy(), w[name]), f"{what}: {name}"
        if track:
            _close(st.s_div_edge, w["q_div"], f"{what}: q_div")
            _close(st.s_div_leaf, w["q_div_leaf"], f"{what}: q_div_leaf")
        seen["take"] |= bool((st.s_logp_prop != prop_before).any())
        seen["turned"] |= bool(st.s_turn.any())
        seen["bad"] |= bool(st.s_div[BAD_CHAIN])
        seen["nan"] |= bool(st.s_div[NAN_CHAIN])
    assert leaf.LAUNCHES == launches  # the CPU runs the plain versions
    assert all(seen.values()), seen
    assert not st.alive[1] and st.s_n_leaves[1] == 0  # a chain not alive stays as it was


def _small_leaf_inputs():
    rng = np.random.default_rng(3)
    metric, inv_mass_j = _case("dense", rng)
    start = _start(rng, inv_mass_j, _make_vg(np.ones(DIM)))
    return metric, start, torch.as_tensor(rng.random((N_LEAVES, C)))


def test_dispatch_runs_the_plain_versions_on_the_cpu(monkeypatch):
    """CPU tensors take the plain versions, bit for bit, and never the
    kernels' wrappers: a doubling's opening (D1's), four leaves' commits
    (L2's, each leaf's index from the pair counter) and its merge (D2's,
    the readout from the pair counter)."""
    def never(*args, **kwargs):
        raise AssertionError("a kernel wrapper ran on CPU tensors")

    for name in ("doubling_open_cuda", "leaf_commit_cuda", "doubling_merge_cuda"):
        monkeypatch.setattr(leaf, name, never)
    metric, start, u_leaf = _small_leaf_inputs()
    a, b = _tree_state(start, True), _tree_state(start, True)
    a.counters, b.counters = torch.zeros(3, dtype=torch.int32), torch.zeros(3, dtype=torch.int32)
    u = _to_the_right()
    vg = _make_vg(np.ones(DIM))
    half, step = leaf.doubling_open(a, u, N_LEAVES, True)
    assert all(torch.equal(x, y) for x, y in zip(leaf.doubling_open_torch(b, u, N_LEAVES, True),
                                                 (half, step)))
    assert all(torch.equal(x, y) for x, y in zip((half, step), _steps()))
    for j in range(4):
        q_n, q_next = a.q[j % 2], a.q[1 - j % 2]
        lp, g = (torch.as_tensor(x) for x in vg(q_n.numpy()))
        rows = _leaf_idx_to_ckpt_idxs(j)
        leaf.leaf_commit(a, metric, half, step, q_n, q_next, lp, g, u_leaf, j, rows,
                         MAX_DELTA_ENERGY, True)
        leaf.leaf_commit_torch(b, metric, half, step, b.q[j % 2], b.q[1 - j % 2], lp, g, u_leaf,
                               j, rows, MAX_DELTA_ENERGY, True, b.counters)
        for k in vars(a):
            assert torch.equal(getattr(a, k), getattr(b, k)), (j, k)
    leaf.doubling_merge(a, u, N_LEAVES, DEPTH + 1, True)
    leaf.doubling_merge_torch(b, u, N_LEAVES, DEPTH + 1, True)
    for k in vars(a):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert a.readout.tolist() == [int(a.done.all()), 4]
    with pytest.raises(ValueError, match="unsupported device"):
        leaf._on_card(torch.zeros(1, device="meta"))


def test_card_branch_raises_when_the_kernels_cannot_build(monkeypatch):
    """The dispatch's card branch, reached through its device predicate,
    raises the build's error: no fallback to the plain versions, nothing
    written, nothing counted."""
    def failed_build(source):
        raise RuntimeError(f"nvcc failed to build {source.name}")

    monkeypatch.setattr(leaf, "_on_card", lambda t: True)
    monkeypatch.setattr(leaf, "_LIB", None)
    monkeypatch.setattr(cuda_band, "build", failed_build)
    metric, start, u_leaf = _small_leaf_inputs()
    st = _tree_state(start, False)
    before = {k: t.clone() for k, t in vars(st).items()}
    launches = dict(leaf.LAUNCHES)
    half, step = _steps()
    u = _to_the_right()
    with pytest.raises(RuntimeError, match="nvcc failed to build nuts_leaf.cu"):
        leaf.doubling_open(st, u, N_LEAVES, False)
    with pytest.raises(RuntimeError, match="nvcc failed to build nuts_leaf.cu"):
        leaf.doubling_merge(st, u, N_LEAVES, DEPTH + 1, False)
    q_n = leaf.leaf_drift_torch(st.cur, half, step)
    lp, g = (torch.as_tensor(x) for x in _make_vg(np.ones(DIM))(q_n.numpy()))
    for m in (metric, DiagMetric(torch.ones(DIM, dtype=torch.float64))):
        with pytest.raises(RuntimeError, match="nvcc failed to build nuts_leaf.cu"):
            leaf.leaf_commit(st, m, half, step, q_n, st.q[1], lp, g, u_leaf, 0, (1, 0),
                             MAX_DELTA_ENERGY, False)
    assert all(torch.equal(getattr(st, k), t) for k, t in before.items())
    assert leaf.LAUNCHES == launches


def test_kernel_source_agrees_with_the_wrapper():
    """The C entry points, L2's pointer and integer arguments in order and
    its counts are the wrapper's; the source builds for sm_90a through
    cuda_band. (D1's and D2's: tests/test_torch_doubling.py.)"""
    src = leaf.SOURCE.read_text()
    for name in (leaf.OPEN, leaf.COMMIT, leaf.MERGE):
        for suffix in ("f32", "f64"):
            assert re.search(rf"int {name}_{suffix}\(", src), (name, suffix)
    (n_ptrs,) = re.findall(r"constexpr int kNumPointers = (\d+);", src)
    (n_ints,) = re.findall(r"constexpr int kNumInts = (\d+);", src)
    assert (int(n_ptrs), int(n_ints)) == (len(leaf.COMMIT_POINTERS), leaf.N_COMMIT_INTS)
    body = src[src.index("struct CommitArgs"):src.index("// ints, in this order")]
    fields = re.findall(r"^\s+(?:const )?\w+\* (\w+);", body, flags=re.M)
    assert tuple(fields) == leaf.COMMIT_POINTERS
    unpacked = re.findall(r"a\.(\w+) = static_cast<[^>]+>\(p\[(\d+)\]\);", src)
    assert [name for name, _ in sorted(unpacked, key=lambda x: int(x[1]))] == list(
        leaf.COMMIT_POINTERS)
    # the integers: unpacked in the wrapper's order, then the two counts
    ints = re.findall(r"a\.(\w+) = [^;]*\bn\[(\d+)\]\)?;", src)
    assert [name for name, _ in sorted(ints, key=lambda x: int(x[1]))] == list(
        leaf.COMMIT_INTS[:-2])
    assert [int(i) for _, i in ints] == list(range(len(leaf.COMMIT_INTS) - 2))
    n_given = len(leaf.COMMIT_INTS) - 2
    assert re.search(rf"int\(n\[{n_given}\]\) != kNumPointers", src) and re.search(
        rf"int\(n\[{n_given + 1}\]\) != kNumInts", src)
    fields = src[src.index("// ints, in this order"):src.index("T max_delta_energy;")]
    declared = re.findall(r"(\w+)(?=[,;])", re.sub(r"//[^\n]*", "", fields))
    assert tuple(declared) == leaf.COMMIT_INTS[:-2]
    assert cuda_band.library_path(leaf.SOURCE).parent == cuda_band.BUILD_DIR


def test_device_rows_mirror_the_checkpoint_rows():
    """L2's row arithmetic (``leaf.device_rows``: (j, lo, hi) from the pair
    counter k and the leaf's parity, as the kernel's ``__popc`` and
    ``__ffs`` compute them) gives every leaf's checkpoint rows, the port's
    and the JAX package's, for j = 0..1023 (a depth-10 doubling's leaves)."""
    js = np.arange(1024, dtype=np.int32)
    lo_j, hi_j = (np.asarray(a) for a in jn._leaf_idx_to_ckpt_idxs(js))
    for j in range(1024):
        rows = leaf.device_rows(j // 2, j % 2)
        assert rows == (j, *_leaf_idx_to_ckpt_idxs(j)) == (j, int(lo_j[j]), int(hi_j[j])), j


def test_plain_commit_with_the_pair_counter():
    """With ``counters`` the plain commit is L2's: the leaf index comes from
    the pair counter (the host gives only its parity), every odd leaf
    advances the counter and sets the leaf loop's condition, k < 2^i / 2
    and any chain alive; the leaf state is the host-indexed commit's, bit
    for bit. The condition falls at the sub-tree's end and when no chain is
    alive."""
    metric, start, u_leaf = _small_leaf_inputs()
    vg = _make_vg(np.ones(DIM))
    host, dev = _torch_state(start, True), _torch_state(start, True)
    dev.counters = torch.zeros(3, dtype=torch.int32)
    conditions = []
    for j in range(N_LEAVES):
        _torch_leaf(host, metric, vg, u_leaf, j, True)
        _torch_leaf(dev, metric, vg, u_leaf, j, True, host_j=j % 2)
        for k in vars(host):
            assert torch.equal(getattr(host, k), getattr(dev, k)), (j, k)
        k, arrived, cond = dev.counters.tolist()
        assert (k, arrived) == ((j + 1) // 2, 0)
        if j % 2:
            assert cond == int(k < N_LEAVES // 2 and bool(dev.alive.any())), j
            conditions.append(cond)
    assert conditions[-1] == 0 and conditions[0] == 1
    dev.counters[leaf.K] = 2  # an odd leaf with no chain alive: the loop ends
    dev.alive.zero_()
    _torch_leaf(dev, metric, vg, u_leaf, 1, True)
    assert dev.counters.tolist() == [3, 0, 0]


def test_bytes_bound_counts_the_launch():
    """D1's and L2's bytes from their data: D1's rows and scalars; L2's per
    chain its steps read and its next leaf's q written; per alive chain the
    rows it reads and writes, and what a take, a checkpoint row or the
    U-turn sweep, and a tracked divergence add; per chain not
    alive the three rows of its state that its drift reads."""
    c, dim, f32 = 128, 799, 4
    assert leaf.open_bytes(c, dim, f32, False) == f32 * (17 * c * dim + 8 * c) + 4 * c + 12
    base = leaf.commit_bytes(c, dim, f32, 1, (0, 0), c, 0, 0, "dense", False)
    counters = 4 * 4  # the pair counter read; an odd leaf's counter, arrivals, condition written
    assert base == f32 * (c * (14 + 3 + 1) * dim + 11 * c) + c + 3 * c + counters
    row = f32 * dim
    assert leaf.commit_bytes(c, dim, f32, 1, (0, 0), c, 7, 0, "dense", False) == base + 7 * (
        5 * row + f32)
    assert leaf.commit_bytes(c, dim, f32, 3, (0, 1), c, 0, 0, "dense", False) == base + c * 3 * row
    assert leaf.commit_bytes(c, dim, f32, 0, (1, 0), c, 0, 0, "dense", False) == (
        base - 3 * 4)  # an even leaf writes one checkpoint row and only reads the counter
    assert leaf.commit_bytes(c, dim, f32, 1, (0, 0), c, 0, 2, "dense", True) == base + 6 * row
    assert leaf.commit_bytes(c, dim, f32, 1, (0, 0), c, 0, 0, "shared", False) == base - (
        c - 1) * row
    frozen = f32 * (c * 4 * dim + 2 * c) + c  # no chain alive: the drift of every chain's state
    assert leaf.commit_bytes(c, dim, f32, 1, (0, 0), 0, 0, 0, "dense", False) == frozen + counters
    assert leaf.commit_bytes(c, dim, f32, 2, (2, 1), 0, 0, 0, "dense", False) == frozen + 4
    assert leaf.commit_bytes(c, dim, f32, 1, (0, 0), c - 3, 0, 0, "dense", False) == base - 3 * (
        f32 * ((14 + 3 + 1 - 4) * dim + 9) + 3)
    assert 6e6 < leaf.commit_bytes(c, dim, f32, 2, (1, 1), c, c // 8, 0, "dense", False) < 10e6


def _gauss_vg(q):
    return -0.5 * (q * q).sum(-1), -q


@pytest.mark.parametrize("case", ["dense-pooled", "diag", "envelope", "pt"])
def test_every_batched_leaf_runs_one_drift_and_one_commit(monkeypatch, case):
    """The samplers' batched leaves (their ``lockstep_leaves``) are the
    commit's calls, one each, and their doublings (``doublings``) the
    opening's and the merge's, one each (the opening drifts leaf 0, the
    commits the leaves after it): what the card's launch counts are held to
    on every NUTS path."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.inference import tempering
    from manifold_constrained_gaussian_process_inference_tpu_torch.parallel import chains

    calls = {"doubling_open": 0, "leaf_commit": 0, "doubling_merge": 0}
    for name in calls:
        def counted(*args, _fn=getattr(leaf, name), _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(leaf, name, counted)
    gen = torch.Generator().manual_seed(0)
    if case == "pt":
        _, info = tempering.run_parallel_tempering(
            _gauss_vg, torch.zeros(3, dtype=torch.float64), gen, n_samples=12, n_adapts=6,
            n_temps=3, max_depth=4)
    else:
        kw = dict(envelope=chains.CurvatureEnvelope(lambda z: np.eye(z.shape[0]))) \
            if case == "envelope" else dict(mass_matrix=case)
        _, info = chains.run_chains(_gauss_vg, torch.zeros((4, 3), dtype=torch.float64), gen,
                                    n_samples=12, n_adapts=6, max_depth=4, **kw)
    assert info["lockstep_leaves"] > info["doublings"] > 0
    assert calls == {"doubling_open": info["doublings"], "leaf_commit": info["lockstep_leaves"],
                     "doubling_merge": info["doublings"]}


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("kind", METRICS)
def test_plain_commit_writes_the_next_drift(kind, track):
    """After every leaf of the sub-tree the commit's ``q_next`` is the plain
    drift of the committed leaf state, bit for bit, for every chain: alive,
    never alive (chain 1) and frozen on the way (the divergent and the NaN
    chain, and those that turned), at even and odd leaves; the q_n it read,
    the drift of the state before the leaf, is left as it was."""
    rng = np.random.default_rng(20 + METRICS.index(kind) + 10 * track)
    scale = rng.uniform(0.5, 2.0, size=DIM)
    metric, inv_mass_j = _case(kind, rng)
    st = _torch_state(_start(rng, inv_mass_j, _make_vg(scale)), track)
    vg, u_leaf = _make_vg(scale), torch.as_tensor(rng.random((N_LEAVES, C)))
    half, step = _steps()
    frozen = set()
    for j in range(N_LEAVES):
        alive = st.alive.clone()
        q_n = leaf.leaf_drift_torch(st.cur, half, step)  # what this leaf's L1 would write
        _torch_leaf(st, metric, vg, u_leaf, j, track)
        assert torch.equal(st.q[1 - j % 2], leaf.leaf_drift_torch(st.cur, half, step)), j
        assert torch.equal(st.q[j % 2], q_n), j
        frozen |= set(np.flatnonzero(~alive.numpy()))
    assert {1, BAD_CHAIN, NAN_CHAIN} <= frozen and len(frozen) < C


@pytest.mark.parametrize("c, dim", [(1, 9), (6, 9), (5, 31), (3, 130)])
def test_dense_velocity_matches_the_jax_product(c, dim):
    """``DenseMetric.velocity`` on the CPU, the plain version of the product
    kernel, against the JAX package's ``_minv_mv_b`` on the same
    non-symmetric M^-1 (rows, not columns: ``p @ minv.T``), to 1e-12."""
    rng = np.random.default_rng(c * dim)
    minv = rng.normal(size=(dim, dim)) + 3 * np.eye(dim)
    g = rng.normal(size=(c, dim))
    got = DenseMetric(*(torch.as_tensor(minv) for _ in range(3))).velocity(torch.as_tensor(g))
    want = np.asarray(jnb._minv_mv_b(jn.DenseMetric(jnp.asarray(minv), jnp.asarray(minv)),
                                     jnp.asarray(g)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    assert not np.allclose(got.numpy(), g @ minv, rtol=1e-6)  # the transpose matters


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc; run on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", METRICS)
def test_cuda_leaf_kernels_match_the_plain_versions(cuda_device, kind):
    """D1 (leaf 0's opening) and L2 on the card against the plain versions
    from the same inputs at every leaf of the sub-tree, float64, both with
    the pair counter: the leaf state to 1e-12, the flags and the counters
    (pair, arrivals, the loop's condition) equal; one D1 at leaf 0 and one
    L2 per leaf. Launched with a stamp buffer (the tracer's, utils/trace.py)
    the kernels write the bits they write with a null one, and stamp their
    stages."""
    rng = np.random.default_rng(7)
    metric, inv_mass_j = _case(kind, rng)
    metric = type(metric)(*(t.to(cuda_device) for t in metric))
    start = _start(rng, inv_mass_j, _make_vg(np.ones(DIM)))
    plain = _tree_state(start, True)
    plain.counters = torch.zeros(3, dtype=torch.int32)
    for k, t in vars(plain).items():
        setattr(plain, k, t.to(cuda_device))
    u_leaf = torch.as_tensor(rng.random((N_LEAVES, C)), device=cuda_device)
    eps = torch.as_tensor(EPS, device=cuda_device)
    half, step = (0.5 * eps)[:, None], eps[:, None]
    vg = _make_vg(np.ones(DIM))
    stamps = torch.zeros(trace.STAMP_WORDS, dtype=torch.int64, device=cuda_device)
    for j in range(N_LEAVES):
        kern = SimpleNamespace(**{k: t.clone() for k, t in vars(plain).items()})
        stamped = SimpleNamespace(**{k: t.clone() for k, t in vars(plain).items()})
        before = dict(leaf.LAUNCHES)
        if j == 0:
            u = _to_the_right().to(cuda_device)
            leaf.doubling_open(kern, u, N_LEAVES, True)
            leaf.doubling_open_cuda(stamped, u, N_LEAVES, True, stamp=stamps.data_ptr())
            leaf.doubling_open_torch(plain, u, N_LEAVES, True)
            assert torch.equal(kern.step, plain.eps) and torch.equal(kern.half, 0.5 * plain.eps)
        q_n = plain.q[j % 2]
        lp, g = (torch.as_tensor(x, device=cuda_device) for x in vg(q_n.cpu().numpy()))
        rows = _leaf_idx_to_ckpt_idxs(j)
        leaf.leaf_commit(kern, metric, half, step, kern.q[j % 2], kern.q[1 - j % 2], lp, g,
                         u_leaf, j, rows, MAX_DELTA_ENERGY, True)
        inv_mass = metric.diagonal()
        leaf.leaf_commit_cuda(stamped, half, step, stamped.q[j % 2], stamped.q[1 - j % 2], lp, g,
                              None if inv_mass is not None else metric.velocity(g), inv_mass,
                              u_leaf, j % 2, MAX_DELTA_ENERGY, True, stamp=stamps.data_ptr())
        leaf.leaf_commit_torch(plain, metric, half, step, q_n, plain.q[1 - j % 2], lp, g, u_leaf,
                               j, rows, MAX_DELTA_ENERGY, True, plain.counters)
        torch.cuda.synchronize()
        assert {k: leaf.LAUNCHES[k] - before[k] for k in before} == {
            leaf.OPEN: 2 * int(j == 0), leaf.COMMIT: 2, leaf.MERGE: 0}
        for k in vars(kern):
            assert torch.equal(getattr(stamped, k), getattr(kern, k)), (j, k)
        # D1 and the L2s stamped in turn: each closes a stage (D1's
        # between_graphs; an L2 given an address closes metric) and opens its own
        hits = stamps[trace.SUMS + len(trace.STAGES):].tolist()
        assert hits[trace.BETWEEN] == 1 and hits[trace.METRIC] == j + 1
        assert int(stamps[trace.CURRENT]) == trace.COMMIT and int(stamps[trace.FIRST]) > 0
        assert torch.equal(kern.q, plain.q)  # D1's and the commit's next positions, bit for bit
        # the plain opening returns the steps, which D1 writes into half
        # and step
        for k in set(vars(plain)) - {"half", "step"}:
            a, b = getattr(kern, k), getattr(plain, k)
            if a.dtype in (torch.bool, torch.int32):
                assert torch.equal(a, b), (j, k)
            else:
                _close(a.cpu().numpy(), b.cpu().numpy(), f"{kind} leaf {j}: {k}")
