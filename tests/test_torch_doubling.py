"""PyTorch port, the doubling's opening and merge (ops/leaf.py): the plain
versions of the kernels D1 and D2, ``doubling_open_torch`` and
``doubling_merge_torch``, held against the JAX package's pieces composed as
its outer loop's body composes them (inference/nuts_batched.py: the edge
select and the sub-tree's init of ``_build_subtree_b`` with
``_leapfrog_b``'s drift; the merge with ``_is_turning_b``, ``jnp.where``
and ``jnp.logaddexp``), on the same inputs, in float64 to rtol 1e-12: dense,
diagonal, per-rung and shared-diagonal metrics, ``track_div_leaf`` on and
off, chains done before the doubling, a divergent and a turned sub-tree, a
log_sum_w of -inf and a sub-tree weight of -inf. The direction and the
merge's uniform are given to both (the JAX body draws its own from the
chains' keys). What D1 does not write (the checkpoint rows) is unread:
filled with NaN before every doubling, a depth-5 transition gives the same
bits at every leaf. The kernels' C
arguments are the wrappers'; the dispatch's card branch raises when the
kernels cannot be built. On a card (tests marked ``cuda``) D1 and D2 agree
with the plain versions and a doubling's graph holds one of each."""
import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manifold_constrained_gaussian_process_inference_tpu.inference import nuts_batched as jnb
from manifold_constrained_gaussian_process_inference_tpu_torch.inference import (
    nuts_batched as nb,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.ops import cuda_band
from manifold_constrained_gaussian_process_inference_tpu_torch.ops import leaf

torch.set_num_threads(1)

C, DIM, RUNGS, DEPTH = 12, 9, 3, 4
N_LEAVES = 1 << DEPTH
RTOL = 1e-12
METRICS = ("dense", "diag", "rung", "shared")
DONE, DIV, TURN, NO_WEIGHT, LSW_INF = (3, 7), 1, 2, 5, 4  # chains
STRAIGHT = [0, 6, 8, 10]
ROWS = ("q", "p", "v", "grad", "mgrad")  # the packed leaf state's


def _velocity(kind, rng):
    """M^-1 x of a metric of ``kind`` (numpy, (C, dim) -> (C, dim))."""
    if kind in ("dense", "rung"):
        a = rng.normal(size=(RUNGS if kind == "rung" else 1, DIM, DIM)) * 0.3
        minv = a @ a.transpose(0, 2, 1) + np.eye(DIM)
        if kind == "dense":
            return lambda x: x @ minv[0].T
        return lambda x: np.einsum("ckj,kij->cki", x.reshape(-1, RUNGS, DIM), minv).reshape(x.shape)
    d = rng.uniform(0.5, 2.0, size=(DIM,) if kind == "shared" else (C, DIM))
    return lambda x: d * x


def _state(vel, rng, p=None):
    """A packed leaf state (C, 5, dim) whose v and mgrad rows are the
    metric's products (``vel``) of its p (drawn where not given) and grad
    rows."""
    q, g = rng.normal(size=(C, DIM)), rng.normal(size=(C, DIM))
    p = rng.normal(size=(C, DIM)) if p is None else p
    return np.stack([q, p, vel(p), g, vel(g)], axis=1)


def _tree_state(kind, rng, track):
    """The tree's buffers as a doubling finds them: the trajectory (both
    edges, the proposal, rho, the sums, chains DONE done, chain LSW_INF's
    log_sum_w -inf) and a sub-tree's end (its last leaf ``cur``, proposal,
    rho, sums; chain DIV diverged, chain TURN turned, chain NO_WEIGHT's
    weight -inf), as numpy arrays. The chains STRAIGHT move along one
    momentum on both edges and in the sub-tree, so that their merged
    trajectory does not turn."""
    vel = _velocity(kind, rng)
    left, right, prop, cur, s_prop = (_state(vel, rng) for _ in range(5))
    rho, s_rho = rng.normal(size=(C, DIM)), rng.normal(size=(C, DIM))
    base = rng.normal(size=(C, DIM))
    for edge in (left, right, cur):
        edge[STRAIGHT] = _state(vel, rng, base)[STRAIGHT]
    rho[STRAIGHT], s_rho[STRAIGHT] = 4 * base[STRAIGHT], 2 * base[STRAIGHT]
    lsw = rng.normal(size=C)
    lsw[LSW_INF] = -np.inf
    s_lsw = rng.normal(size=C) + 0.5
    s_lsw[NO_WEIGHT] = -np.inf
    done = np.zeros(C, bool)
    done[list(DONE)] = True
    s_div, s_turn = np.zeros(C, bool), np.zeros(C, bool)
    s_div[DIV], s_turn[TURN] = True, True
    st = dict(
        left=left, right=right, prop=prop, rho=rho,
        logp_prop=rng.normal(size=C), log_sum_w=lsw, sum_accept=rng.uniform(0, 3, C),
        num_leaves=rng.integers(1, 9, C).astype(float), diverging=np.zeros(C, bool), done=done,
        depth=np.full(C, DEPTH, np.int32), eps=rng.uniform(0.01, 0.5, C),
        cur=cur, s_prop=s_prop, s_rho=s_rho, s_lsw=s_lsw,
        s_logp_prop=rng.normal(size=C), s_sum_accept=rng.uniform(0, 3, C),
        s_n_leaves=rng.integers(1, 9, C).astype(float), s_div=s_div, s_turn=s_turn,
        alive=rng.random(C) < 0.5,
        ckpts=rng.normal(size=(C, DEPTH, 3, DIM)), q=rng.normal(size=(2, C, DIM)),
    )
    if track:
        st.update(div_edge=np.zeros((C, DIM)), div_leaf=np.zeros((C, DIM)),
                  s_div_edge=rng.normal(size=(C, DIM)), s_div_leaf=rng.normal(size=(C, DIM)))
    return st


def _torch(st):
    """The port's state: the arrays as tensors, with the pair counter (3
    pairs run) and the readout."""
    out = SimpleNamespace(**{k: torch.as_tensor(v).clone() for k, v in st.items()})
    out.counters = torch.tensor([3, 0, 1], dtype=torch.int32)
    out.readout = torch.zeros(2, dtype=torch.int64)
    return out


def _uniforms(rng):
    """A doubling's (2, C) uniforms: the direction's (both ways) and the merge's."""
    u = rng.random((2, C))
    u[0, ::2] = rng.uniform(0.0, 0.5, size=(C + 1) // 2)  # even chains to the right
    u[0, 1::2] = rng.uniform(0.5, 1.0, size=C // 2)
    return u


def _close(got, want, what):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    scale = max(1.0, float(np.nanmax(np.abs(np.where(np.isfinite(want), want, 0.0)))))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale, err_msg=what)


def _jax_merge(st, u, track):
    """The JAX package's merge (the outer loop's body, :423-489) composed
    over the same buffers: each field of the packed rows by its own
    ``jnp.where``, the U-turn check by ``_is_turning_b``."""
    j = {k: jnp.asarray(v) for k, v in st.items()}
    upd = ~j["done"]
    gr_col = jnp.asarray(u[0] < 0.5)[:, None]
    valid = upd & ~(j["s_div"] | j["s_turn"])
    valid_col = valid[:, None]
    log_ratio = j["s_lsw"] - j["log_sum_w"]
    take_new = valid & (jnp.asarray(u[1]) < jnp.exp(jnp.minimum(0.0, log_ratio)))
    take_col = take_new[:, None]
    tree = {f"{name}_{side}": j[side][:, r] for r, name in enumerate(ROWS)
            for side in ("left", "right")}
    sub = {name: j["cur"][:, r] for r, name in enumerate(ROWS)}
    new = {}
    for name in ROWS:
        new[f"{name}_left"] = jnp.where(gr_col, tree[f"{name}_left"], sub[name])
        new[f"{name}_right"] = jnp.where(gr_col, sub[name], tree[f"{name}_right"])
    rho = j["rho"] + j["s_rho"]
    turning_combined = jnb._is_turning_b(new["p_left"], new["v_left"], new["p_right"],
                                         new["v_right"], rho)
    out = {
        "left": np.stack([np.asarray(jnp.where(valid_col, new[f"{n}_left"], tree[f"{n}_left"]))
                          for n in ROWS], axis=1),
        "right": np.stack([np.asarray(jnp.where(valid_col, new[f"{n}_right"],
                                                tree[f"{n}_right"])) for n in ROWS], axis=1),
        "prop": np.stack([np.asarray(jnp.where(take_col, j["s_prop"][:, r], j["prop"][:, r]))
                          for r in range(5)], axis=1),
        "logp_prop": jnp.where(take_new, j["s_logp_prop"], j["logp_prop"]),
        "rho": jnp.where(valid_col, rho, j["rho"]),
        "log_sum_w": jnp.where(valid, jnp.logaddexp(j["log_sum_w"], j["s_lsw"]),
                               j["log_sum_w"]),
        "sum_accept": jnp.where(upd, j["sum_accept"] + j["s_sum_accept"], j["sum_accept"]),
        "num_leaves": jnp.where(upd, j["num_leaves"] + j["s_n_leaves"], j["num_leaves"]),
        "diverging": jnp.where(upd, j["diverging"] | j["s_div"], j["diverging"]),
        "done": j["done"] | (upd & (j["s_div"] | j["s_turn"] | turning_combined)),
        "depth": jnp.where(upd, DEPTH + 1, j["depth"]),
    }
    if track:
        hit = (upd & j["s_div"])[:, None]
        out["div_edge"] = jnp.where(hit, j["s_div_edge"], j["div_edge"])
        out["div_leaf"] = jnp.where(hit, j["s_div_leaf"], j["div_leaf"])
    seen = dict(take=np.asarray(take_new), valid=np.asarray(valid),
                turned=np.asarray(valid & turning_combined))
    return {k: np.asarray(v) for k, v in out.items()}, seen


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("kind", METRICS)
def test_plain_merge_matches_the_jax_body(kind, track):
    rng = np.random.default_rng(METRICS.index(kind) + 10 * track)
    st = _tree_state(kind, rng, track)
    u = _uniforms(rng)
    want, seen = _jax_merge(st, u, track)
    got = _torch(st)
    before = {k: t.clone() for k, t in vars(got).items()}
    leaf.doubling_merge_torch(got, torch.as_tensor(u), N_LEAVES, DEPTH + 1, track)
    what = f"{kind} track={track}"
    for key, w in want.items():
        g = getattr(got, key).numpy()
        if w.dtype == bool or key == "depth":
            assert np.array_equal(g, w), f"{what}: {key}"
        else:
            _close(g, w, f"{what}: {key}")
    assert got.readout.tolist() == [int(want["done"].all()), 6]
    # the sub-tree's buffers are read, not written
    for key in ("cur", "s_prop", "s_rho", "s_lsw", "s_div", "s_turn", "alive", "ckpts"):
        assert torch.equal(getattr(got, key), before[key]), key
    # every decision both ways: a chain done before, a divergent and a
    # turned sub-tree, valid chains taking and not, turning and not
    valid = seen["valid"]
    assert not valid[list(DONE)].any() and not valid[DIV] and not valid[TURN]
    assert seen["take"][LSW_INF] and not seen["take"][NO_WEIGHT]
    assert seen["take"].any() and (valid & ~seen["take"]).any()
    assert seen["turned"].any() and (valid & ~seen["turned"]).any()
    assert got.diverging[DIV] and got.done[DIV] and got.done[TURN]


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("kind", METRICS)
def test_plain_open_matches_the_jax_subtree_init(kind, track):
    """The opening's edge, sub-tree and steps against the JAX body's edge
    select and ``_build_subtree_b``'s init (:304-322), leaf 0's position
    against the q that ``_leapfrog_b`` hands the value-and-grad."""
    rng = np.random.default_rng(20 + METRICS.index(kind) + 10 * track)
    st = _tree_state(kind, rng, track)
    u = _uniforms(rng)
    got = _torch(st)
    before = {k: t.clone() for k, t in vars(got).items()}
    half, step = leaf.doubling_open_torch(got, torch.as_tensor(u), N_LEAVES, track)

    gr_col = jnp.asarray(u[0] < 0.5)[:, None]
    direction = jnp.where(jnp.asarray(u[0] < 0.5), 1.0, -1.0)
    eps_signed = direction * jnp.asarray(st["eps"])
    edge = {name: jnp.where(gr_col, jnp.asarray(st["right"][:, r]), jnp.asarray(st["left"][:, r]))
            for r, name in enumerate(ROWS)}
    drifted = []

    def vg_b(q_new):
        drifted.append(np.asarray(q_new))
        return jnp.zeros(C), jnp.zeros((C, DIM))

    jnb._leapfrog_b(vg_b, edge["q"], edge["p"], edge["v"], edge["mgrad"], edge["grad"],
                    eps_signed, jnp.ones(DIM))
    what = f"{kind} track={track}"
    _close(step[:, 0], eps_signed, f"{what}: step")
    _close(half[:, 0], 0.5 * eps_signed, f"{what}: half")
    _close(got.q[0], drifted[0], f"{what}: leaf 0's q")
    for r, name in enumerate(ROWS):
        _close(got.cur[:, r], edge[name], f"{what}: cur {name}")
        _close(got.s_prop[:, r], edge[name], f"{what}: the sub-tree's proposal {name}")
    upd = ~st["done"]
    assert np.array_equal(got.alive.numpy(), upd)
    assert not got.s_rho.any() and not got.s_logp_prop.any() and not got.s_sum_accept.any()
    assert not got.s_n_leaves.any() and not got.s_div.any() and not got.s_turn.any()
    assert np.isneginf(got.s_lsw.numpy()).all()
    assert got.counters.tolist() == [0, 0, 0]
    if track:
        assert not got.s_div_edge.any() and not got.s_div_leaf.any()
    # the trajectory and the checkpoint rows as they were
    for key in ("left", "right", "prop", "rho", "log_sum_w", "done", "ckpts", "q"):
        t = getattr(got, key)
        assert torch.equal(t[1] if key == "q" else t, before[key][1] if key == "q"
                           else before[key]), key


def _gauss_vg(scale):
    def vg(q):
        return -0.5 * (scale * q * q).sum(-1), -scale * q

    return vg


def _snapshots(monkeypatch, fill_nan: bool, track: bool):
    """Every buffer of a depth-5 transition's tree after each leaf and each
    merge but the checkpoint rows (NaN-filled before every doubling where
    ``fill_nan``), and the transition's outputs."""
    c, dim = 6, 4
    scale = torch.tensor([1.0, 2.0, 0.5, 3.0], dtype=torch.float64)
    q = torch.as_tensor(np.random.default_rng(5).normal(size=(c, dim)))
    eps = torch.as_tensor(np.geomspace(0.01, 1.5, c))
    vg = _gauss_vg(scale)
    shots = []
    real_open, real_commit, real_merge = (leaf.doubling_open_torch, leaf.leaf_commit,
                                          leaf.doubling_merge)

    def snapshot(st):
        shots.append({k: t.clone() for k, t in vars(st).items()
                      if isinstance(t, torch.Tensor) and k != "ckpts"})
        shots[-1]["nan_left"] = st.ckpts.isnan().any()

    def opening(st, *args):
        if fill_nan:
            st.ckpts.fill_(torch.nan)
        return real_open(st, *args)

    def commit(st, *args, **kwargs):
        real_commit(st, *args, **kwargs)
        snapshot(st)

    def merge(st, *args):
        real_merge(st, *args)
        snapshot(st)

    monkeypatch.setattr(leaf, "doubling_open_torch", opening)
    monkeypatch.setattr(leaf, "leaf_commit", commit)
    monkeypatch.setattr(leaf, "doubling_merge", merge)
    tree = nb.LockstepTree(vg, torch.Generator().manual_seed(11), max_depth=5,
                           track_div_leaf=track)
    out = tree(q, *vg(q), eps, nb.DenseMetric(*(torch.eye(dim, dtype=torch.float64),) * 3))
    monkeypatch.undo()
    return shots, out


@pytest.mark.parametrize("track", [False, True])
def test_unwritten_buffers_are_unread(monkeypatch, track):
    """The buffer D1 leaves as it was, the checkpoint rows, filled with NaN
    before every doubling: every other buffer the same bits after every
    leaf and every merge of a depth-5 transition, the same outputs."""
    want, out_want = _snapshots(monkeypatch, False, track)
    got, out_got = _snapshots(monkeypatch, True, track)
    assert int(out_want[3].tree_depth.max()) == 5 and len(got) == len(want) > 32
    for i, (a, b) in enumerate(zip(got, want)):
        for k in set(b) - {"nan_left"}:
            assert torch.equal(a[k].isnan(), b[k].isnan()) and torch.equal(
                a[k].nan_to_num(), b[k].nan_to_num()), (i, k)
    for a, b in zip(out_got, out_want):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
    # the fill reached the leaves: NaN rows left while they ran
    assert any(bool(shot["nan_left"]) for shot in got)


def _struct(src, name, ints_marker):
    """A kernel argument struct's pointer fields and integer fields."""
    body = src[src.index(f"struct {name} {{"):]
    body = body[:body.index("};")]
    ptrs, ints = body.split(ints_marker)
    pointers = re.findall(r"^\s+(?:const )?\w+\* (\w+);", ptrs, flags=re.M)
    integers = re.findall(r"(\w+)(?=[,;])", re.sub(r"//[^\n]*", "", ints.replace("int ", "")))
    return tuple(pointers), tuple(integers)


@pytest.mark.parametrize("which", ["open", "merge"])
def test_kernel_source_agrees_with_the_wrapper(which):
    """D1's and D2's C entry points in both types, their pointer and integer
    arguments in the order of the wrappers' names, unpacked in that order,
    and the two counts each kernel checks."""
    src = leaf.SOURCE.read_text()
    name, struct, var, count = {
        "open": (leaf.OPEN, "OpenArgs", "o", "Open"),
        "merge": (leaf.MERGE, "MergeArgs", "m", "Merge")}[which]
    pointers, ints = {"open": (leaf.OPEN_POINTERS, leaf.OPEN_INTS),
                      "merge": (leaf.MERGE_POINTERS, leaf.MERGE_INTS)}[which]
    for suffix in ("f32", "f64"):
        assert re.search(rf"int {name}_{suffix}\(void\* const\* ptrs, const long long\* ints, "
                         rf"void\* stream\)", src), suffix
    (n_ptrs,) = re.findall(rf"constexpr int k{count}Pointers = (\d+);", src)
    (n_ints,) = re.findall(rf"constexpr int k{count}Ints = (\d+);", src)
    assert (int(n_ptrs), int(n_ints)) == (len(pointers), len(ints))
    assert _struct(src, struct, "// the integers, in this order") == (pointers, ints[:-2])
    unpacked = re.findall(rf"\b{var}\.(\w+) = static_cast<[^>]+>\(p\[(\d+)\]\);", src)
    assert [n for n, _ in unpacked] == list(pointers)
    assert [int(i) for _, i in unpacked] == list(range(len(pointers)))
    read = re.findall(rf"\b{var}\.(\w+) = int\(n\[(\d+)\]\);", src)
    assert [n for n, _ in read] == list(ints[:-2])
    assert [int(i) for _, i in read] == list(range(len(ints) - 2))
    k = len(ints) - 2
    assert re.search(rf"int\(n\[{k}\]\) != k{count}Pointers", src)
    assert re.search(rf"int\(n\[{k + 1}\]\) != k{count}Ints", src)


def test_card_branch_raises_when_the_kernels_cannot_build(monkeypatch):
    """The dispatch's card branch for D1 and D2, reached through its device
    predicate, raises the build's error: no fallback to the plain versions,
    nothing written, nothing counted."""
    def failed_build(source):
        raise RuntimeError(f"nvcc failed to build {source.name}")

    monkeypatch.setattr(leaf, "_on_card", lambda t: True)
    monkeypatch.setattr(leaf, "_LIB", None)
    monkeypatch.setattr(cuda_band, "build", failed_build)
    rng = np.random.default_rng(0)
    st = _torch(_tree_state("dense", rng, True))
    st.half, st.step = torch.zeros(C, dtype=torch.float64), torch.zeros(C, dtype=torch.float64)
    before = {k: t.clone() for k, t in vars(st).items()}
    launches = dict(leaf.LAUNCHES)
    u = torch.as_tensor(_uniforms(rng))
    with pytest.raises(RuntimeError, match="nvcc failed to build nuts_leaf.cu"):
        leaf.doubling_open(st, u, N_LEAVES, True)
    with pytest.raises(RuntimeError, match="nvcc failed to build nuts_leaf.cu"):
        leaf.doubling_merge(st, u, N_LEAVES, DEPTH + 1, True)
    assert all(torch.equal(getattr(st, k), t) for k, t in before.items())
    assert leaf.LAUNCHES == launches


def test_bytes_bounds_count_the_launch():
    """D1's bytes: the edge read, cur and the proposal, leaf 0's q and rho
    written (and the tracked pair), the per-chain scalars and flags, the
    counters. D2's from its data: per valid chain 15 rows, per take 10, per
    tracked divergent sub-tree 4, and the per-chain scalars and flags."""
    c, dim, f32 = 128, 799, 4
    row = f32 * dim
    base = leaf.open_bytes(c, dim, f32, False)
    assert base == f32 * (17 * c * dim + 8 * c) + 4 * c + 12
    assert leaf.open_bytes(c, dim, f32, True) == base + 2 * c * row
    none = leaf.merge_bytes(c, dim, f32, 0, 0, 0, 0, False)
    assert none == c + 20  # every done flag read, the counter read, the readout written
    upd = leaf.merge_bytes(c, dim, f32, 10, 0, 0, 0, False)
    assert upd == none + 10 * (6 * f32 + 7)
    valid = leaf.merge_bytes(c, dim, f32, 10, 8, 0, 0, False)
    assert valid == upd + 8 * (15 * row + 5 * f32)
    assert leaf.merge_bytes(c, dim, f32, 10, 8, 3, 0, False) == valid + 3 * (10 * row + 2 * f32)
    assert leaf.merge_bytes(c, dim, f32, 10, 8, 0, 2, True) == valid + 2 * (4 * row + 1)
    assert leaf.merge_bytes(c, dim, f32, 10, 8, 0, 2, False) == valid + 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc; run on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("kind", METRICS)
def test_cuda_doubling_kernels_match_the_plain_versions(cuda_device, kind, track):
    """D1 and D2 on the card against the plain versions from the same
    state, float64: every buffer bit-equal (done within rounding of a row
    dot's 0; none here), D2's readout from the pair counter."""
    rng = np.random.default_rng(40 + METRICS.index(kind) + 10 * track)
    st = _tree_state(kind, rng, track)
    u = torch.as_tensor(_uniforms(rng), device=cuda_device)
    plain, kern = _torch(st), _torch(st)
    for s in (plain, kern):
        s.half, s.step = torch.zeros(C, dtype=torch.float64), torch.zeros(C, dtype=torch.float64)
        for k, t in vars(s).items():
            setattr(s, k, t.to(cuda_device))
    half, step = leaf.doubling_open_torch(plain, u, N_LEAVES, track)
    k_half, k_step = leaf.doubling_open(kern, u, N_LEAVES, track)
    assert torch.equal(k_half, half) and torch.equal(k_step, step)
    for k in set(vars(plain)) - {"half", "step"}:
        assert torch.equal(getattr(kern, k), getattr(plain, k)), k
    fresh = _torch(_tree_state(kind, rng, track))  # a sub-tree's end over the opening
    for k in ("cur", "s_prop", "s_rho", "s_lsw", "s_logp_prop", "s_sum_accept", "s_n_leaves",
              "s_div", "s_turn") + (("s_div_edge", "s_div_leaf") if track else ()):
        for s in (plain, kern):
            getattr(s, k).copy_(getattr(fresh, k))
    for s in (plain, kern):
        s.counters.copy_(torch.tensor([3, 0, 1], dtype=torch.int32))
    leaf.doubling_merge_torch(plain, u, N_LEAVES, DEPTH + 1, track)
    leaf.doubling_merge(kern, u, N_LEAVES, DEPTH + 1, track)
    for k in set(vars(plain)) - {"half", "step", "counters"}:
        assert torch.equal(getattr(kern, k), getattr(plain, k)), k
    assert kern.counters.tolist() == [3, 0, 1]


@pytest.mark.cuda
def test_cuda_doubling_graphs_hold_one_open_and_one_merge(cuda_device):
    """Every depth's graph captures one D1, one D2 and one L2 per captured
    leaf; the depth-0 graph's top-level nodes are its leaf's and its draws'
    and D1's and D2's."""
    def vg(q):
        return -0.5 * (q * q).sum(-1), -q

    c, dim = 8, 5
    q = torch.as_tensor(np.random.default_rng(0).normal(size=(c, dim)), device=cuda_device)
    eps = torch.as_tensor(np.geomspace(0.004, 1.5, c), device=cuda_device)
    eye = torch.eye(dim, dtype=torch.float64, device=cuda_device)
    tree = nb.LockstepTree(vg, torch.Generator(device=cuda_device).manual_seed(1), 10,
                           graphed=True)
    bound = tree._bind(q, eps, nb.DenseMetric(eye, eye, eye))
    for i in range(4):
        tree.graphs[i] = tree._capture(bound, i)
    info = tree.graph_info
    for i in range(4):
        assert info[i]["leaf_launches"] == {leaf.OPEN: 1, leaf.COMMIT: min(1 << i, 4),
                                            leaf.MERGE: 1}
    per_leaf = info[1]["nodes"] - info[0]["nodes"]  # leaf 1's nodes
    assert info[0]["nodes"] <= per_leaf + 6
