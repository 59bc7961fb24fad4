"""PyTorch port, the NUTS lockstep tree (inference/nuts_batched.py
``LockstepTree``): the in-place, pair-guarded tree run eagerly gives the
bits of the transition it replaced (kept below, frozen) in float64 under
the dense, the diagonal and the per-rung metric, with and without
``track_div_leaf``, at C = 1, 3 and 8, at max_depth 10 and at a depth the
trees hit; the schedule the card runs (one graph replay and one host read
per doubling; in the graph leaves 0 and 1, then the pair body while the
condition that the odd leaves' commits set holds, the leaf indices from the
pair counter) gives the same bits; the graph path is chosen for a CUDA
device and a value-and-grad without a collective only; the samplers
(pooled, diag, PT, the envelope's tracked warmup) keep one tree across
their transitions."""
from typing import Callable, NamedTuple, Optional

import numpy as np
import pytest
import torch

from manifold_constrained_gaussian_process_inference_tpu_torch.inference import (
    nuts_batched as nb,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.inference import tempering as tt
from manifold_constrained_gaussian_process_inference_tpu_torch.inference.nuts import (
    MAX_DELTA_ENERGY,
    DenseMetric,
    DiagMetric,
    NutsStats,
    RungDenseMetric,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.ops import leaf
from manifold_constrained_gaussian_process_inference_tpu_torch.parallel import chains as tc
from manifold_constrained_gaussian_process_inference_tpu_torch.parallel.mesh import local_draw

torch.set_num_threads(1)

# ---------------------------------------------------------------------------
# The transition before the tree state moved into buffers updated in place:
# host-integer leaf loop, fresh tensors per leaf, a host read after every odd
# leaf. Frozen here as the bit-for-bit reference.
# ---------------------------------------------------------------------------

Q, P, V, G, MG = range(5)


def _popcount32(x: int) -> int:
    return bin(int(x)).count("1")


def _leaf_idx_to_ckpt_idxs(n: int):
    idx_max = _popcount32(n >> 1)
    n_trail = _popcount32(((n + 1) & -(n + 1)) - 1)
    return idx_max - n_trail + 1, idx_max


def _rowdot(a, b):
    """Per-chain dot product: (C, dim) x (C, dim) -> (C,). An elementwise
    product summed along its rows rounds a row alike at any C; an einsum
    is a batched GEMM on the card, whose rounding of a row depends on the
    batch's size, so a chain would not compute the same energy in a shard
    of a mesh as in the whole batch."""
    return (a * b).sum(-1)


def _is_turning_b(p_left, v_left, p_right, v_right, rho):
    """(C,) generalized U-turn check with the boundary-momentum correction;
    v_* are the carried M^-1 p_*."""
    rho_c = rho - 0.5 * (p_left + p_right)
    return (_rowdot(v_left, rho_c) <= 0.0) | (_rowdot(v_right, rho_c) <= 0.0)


def _is_iterative_turning_b(p_leaf, v_leaf, rho_cum, ckpts):
    """U-turn checks of every sub-tree ending at this odd leaf, over the
    active checkpoint rows ``ckpts`` (C, R, 3, dim) = [p, v, rho]."""
    r, v_ck, rho_ck = ckpts.unbind(2)
    rho_c = rho_cum[:, None, :] - rho_ck + r - 0.5 * (r + p_leaf[:, None, :])
    t_left = (v_ck * rho_c).sum(-1) <= 0.0
    t_right = (rho_c * v_leaf[:, None, :]).sum(-1) <= 0.0
    return torch.any(t_left | t_right, dim=1)


class SubTree(NamedTuple):
    first: torch.Tensor       # (C, 5, dim) first leaf in build order
    last: torch.Tensor        # (C, 5, dim) last committed leaf
    rho: torch.Tensor         # (C, dim) sum of the committed momenta
    prop: torch.Tensor        # (C, 5, dim) proposal leaf
    logp_prop: torch.Tensor
    log_sum_w: torch.Tensor
    sum_accept: torch.Tensor
    num_leaves: torch.Tensor
    diverging: torch.Tensor
    turning: torch.Tensor
    leaves_run: int           # batched leapfrog steps run (host count)
    host_syncs: int
    # the divergent step's edge and exploded leaf (C, dim), when tracked
    div_edge: Optional[torch.Tensor] = None
    div_leaf: Optional[torch.Tensor] = None


def _build_subtree_b(
    vg_b, edge, num_leaves: int, eps_signed, metric, h0, alive0,
    generator, max_delta_energy, mesh=None, track_div_leaf: bool = False,
) -> SubTree:
    """``num_leaves`` leapfrog steps outward from ``edge`` for every chain
    alive in ``alive0``. A chain commits each leaf while alive and freezes
    at the leaf where it diverges or its sub-tree turns (so a tracked
    divergent step is written once per sub-tree)."""
    C, _, dim = edge.shape
    dtype, device = edge.dtype, edge.device
    n_rows = max(num_leaves.bit_length() - 1, 1)
    ckpts = torch.zeros((C, n_rows, 3, dim), dtype=dtype, device=device)
    u_leaf = local_draw(torch.rand, generator, (num_leaves, C), 1, mesh, dtype, device)
    half = (0.5 * eps_signed)[:, None]
    step = eps_signed[:, None]

    cur, first = edge, edge
    rho = torch.zeros((C, dim), dtype=dtype, device=device)
    prop = edge
    logp_prop = torch.zeros(C, dtype=dtype, device=device)
    log_sum_w = torch.full((C,), -torch.inf, dtype=dtype, device=device)
    sum_accept = torch.zeros(C, dtype=dtype, device=device)
    n_leaves = torch.zeros(C, dtype=dtype, device=device)
    diverging = torch.zeros(C, dtype=torch.bool, device=device)
    turning = torch.zeros(C, dtype=torch.bool, device=device)
    alive = alive0
    host_syncs = 0
    div_edge = div_leaf = None
    if track_div_leaf:
        div_edge = torch.zeros((C, dim), dtype=dtype, device=device)
        div_leaf = torch.zeros((C, dim), dtype=dtype, device=device)

    for j in range(num_leaves):
        q, p, v, g, mg = cur.unbind(1)
        p_half = p + half * g
        v_half = v + half * mg
        q_n = q + step * v_half
        logp_n, g_n = vg_b(q_n)
        mg_n = metric.velocity(g_n)
        p_n = p_half + half * g_n
        v_n = v_half + half * mg_n
        leaf = torch.stack([q_n, p_n, v_n, g_n, mg_n], dim=1)

        delta = -logp_n + 0.5 * _rowdot(p_n, v_n) - h0
        bad = ~(delta <= max_delta_energy)  # NaN -> True
        w = torch.where(bad, -torch.inf, -delta)
        accept = torch.where(bad, 0.0, torch.exp(torch.clamp(-delta, max=0.0)))
        lsw = torch.logaddexp(log_sum_w, w)
        take = alive & (u_leaf[j] < torch.exp(w - lsw))
        prop = torch.where(take[:, None, None], leaf, prop)
        logp_prop = torch.where(take, logp_n, logp_prop)

        alive3 = alive[:, None, None]
        rho = torch.where(alive[:, None], rho + p_n, rho)
        if j == 0:
            first = torch.where(alive3, leaf, first)
        if j % 2 == 0:
            row = _popcount32(j >> 1)
            ckpts[:, row] = torch.where(
                alive3, torch.stack([p_n, v_n, rho], dim=1), ckpts[:, row]
            )
            stop = bad
        else:
            lo, hi = _leaf_idx_to_ckpt_idxs(j)
            turned = _is_iterative_turning_b(p_n, v_n, rho, ckpts[:, lo : hi + 1])
            turning = torch.where(alive, turned, turning)
            stop = bad | turned

        if track_div_leaf:
            newly_bad = (alive & bad)[:, None]
            div_edge = torch.where(newly_bad, q, div_edge)
            div_leaf = torch.where(newly_bad, q_n, div_leaf)
        cur = torch.where(alive3, leaf, cur)
        log_sum_w = torch.where(alive, lsw, log_sum_w)
        sum_accept = sum_accept + torch.where(alive, accept, 0.0)
        n_leaves = n_leaves + alive
        diverging = diverging | (alive & bad)
        alive = alive & ~stop
        if j % 2 == 1 and j + 1 < num_leaves:
            host_syncs += 1
            if not bool(alive.any()):
                break

    return SubTree(
        first=first, last=cur, rho=rho, prop=prop, logp_prop=logp_prop,
        log_sum_w=log_sum_w, sum_accept=sum_accept, num_leaves=n_leaves,
        diverging=diverging, turning=turning, leaves_run=j + 1,
        host_syncs=host_syncs, div_edge=div_edge, div_leaf=div_leaf,
    )


def reference_transition(
    vg_b: Callable,
    q: torch.Tensor,         # (C, dim)
    logp: torch.Tensor,      # (C,)
    grad: torch.Tensor,      # (C, dim)
    step_size,               # scalar or (C,)
    metric,                  # DenseMetric or DiagMetric
    generator: torch.Generator,
    max_depth: int = 10,
    max_delta_energy: float = MAX_DELTA_ENERGY,
    mesh=None,
    track_div_leaf: bool = False,
):
    """One NUTS transition for all C chains under ``metric``.
    ``vg_b`` maps (C, dim) -> ((C,), (C, dim)). Under a chain ``mesh`` the
    C chains are this rank's block (see the module docstring). Returns
    (q', logp', grad', NutsStats), and with ``track_div_leaf`` a fifth
    output: (edge, leaf), each (C, dim), the two endpoints of each chain's
    divergent leapfrog step (zeros for a chain that did not diverge)."""
    C, dim = q.shape
    dtype, device = q.dtype, q.device
    eps = torch.as_tensor(step_size, dtype=dtype, device=device).expand(C)

    z = local_draw(torch.randn, generator, (C, dim), 0, mesh, dtype, device)
    p0 = metric.momentum(z)
    v0 = metric.velocity(p0)
    h0 = -logp + 0.5 * _rowdot(p0, v0)
    left = right = torch.stack([q, p0, v0, grad, metric.velocity(grad)], dim=1)
    rho = p0
    prop = left
    logp_prop = logp
    log_sum_w = torch.zeros(C, dtype=dtype, device=device)
    sum_accept = torch.zeros(C, dtype=dtype, device=device)
    num_leaves = torch.zeros(C, dtype=dtype, device=device)
    diverging = torch.zeros(C, dtype=torch.bool, device=device)
    depth = torch.zeros(C, dtype=torch.int32, device=device)
    done = torch.zeros(C, dtype=torch.bool, device=device)
    host_syncs = lockstep_leaves = doublings = 0
    if track_div_leaf:
        div_edge = torch.zeros((C, dim), dtype=dtype, device=device)
        div_leaf = torch.zeros((C, dim), dtype=dtype, device=device)

    for i in range(max_depth):
        if i > 0:
            host_syncs += 1
            if bool(done.all()):
                break
        doublings += 1
        upd = ~done
        u = local_draw(torch.rand, generator, (2, C), 1, mesh, dtype, device)
        go_right = u[0] < 0.5
        gr3 = go_right[:, None, None]
        direction = torch.where(go_right, 1.0, -1.0).to(dtype)
        sub = _build_subtree_b(
            vg_b, torch.where(gr3, right, left), 1 << i, direction * eps,
            metric, h0, upd, generator, max_delta_energy, mesh, track_div_leaf,
        )
        lockstep_leaves += sub.leaves_run
        host_syncs += sub.host_syncs
        valid = upd & ~(sub.diverging | sub.turning)
        take_new = valid & (
            u[1] < torch.exp(torch.clamp(sub.log_sum_w - log_sum_w, max=0.0))
        )
        prop = torch.where(take_new[:, None, None], sub.prop, prop)
        logp_prop = torch.where(take_new, sub.logp_prop, logp_prop)

        # the sub-tree's last leaf is the new outer edge in its direction
        new_left = torch.where(gr3, left, sub.last)
        new_right = torch.where(gr3, sub.last, right)
        new_rho = rho + sub.rho
        turning_combined = _is_turning_b(
            new_left[:, P], new_left[:, V], new_right[:, P], new_right[:, V], new_rho
        )
        valid3 = valid[:, None, None]
        left = torch.where(valid3, new_left, left)
        right = torch.where(valid3, new_right, right)
        rho = torch.where(valid[:, None], new_rho, rho)
        log_sum_w = torch.where(
            valid, torch.logaddexp(log_sum_w, sub.log_sum_w), log_sum_w
        )
        sum_accept = sum_accept + torch.where(upd, sub.sum_accept, 0.0)
        num_leaves = num_leaves + torch.where(upd, sub.num_leaves, 0.0)
        if track_div_leaf:
            # one divergent sub-tree at most per transition: done is set
            hit = (upd & sub.diverging)[:, None]
            div_edge = torch.where(hit, sub.div_edge, div_edge)
            div_leaf = torch.where(hit, sub.div_leaf, div_leaf)
        diverging = diverging | (upd & sub.diverging)
        done = done | (upd & (sub.diverging | sub.turning | turning_combined))
        depth = torch.where(upd, i + 1, depth)

    if mesh is not None:
        # the draws of the doublings the deepest rank ran and this one did not
        host_syncs += 1
        full = C * mesh.size
        for i in range(doublings, mesh.max_int(doublings)):
            torch.rand((2, full), generator=generator, dtype=dtype, device=device)
            torch.rand((1 << i, full), generator=generator, dtype=dtype, device=device)

    stats = NutsStats(
        accept_prob=sum_accept / torch.clamp(num_leaves, min=1.0),
        num_leapfrog=num_leaves,
        tree_depth=depth,
        diverging=diverging,
        energy=h0,
        step_size=eps,
        host_syncs=host_syncs,
        lockstep_leaves=lockstep_leaves,
    )
    if track_div_leaf:
        return prop[:, Q], logp_prop, prop[:, G], stats, (div_edge, div_leaf)
    return prop[:, Q], logp_prop, prop[:, G], stats


# ---------------------------------------------------------------------------
# Cases
# ---------------------------------------------------------------------------

DIM = 5
CLIFF = 2.0  # the density is NaN beyond q0 > CLIFF: large steps diverge there


def _case(metric_kind: str, c: int, seed: int = 0):
    """A correlated Gaussian with a cliff, start positions, per-chain step
    sizes from 0.004 (trees to depth 10) to 1.5 (divergences), and the
    metric."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(DIM, DIM))
    prec = torch.as_tensor(np.linalg.inv(a @ a.T / DIM + np.eye(DIM)))

    def vg(q):
        g = -q @ prec
        lp = 0.5 * (g * q).sum(-1)
        return torch.where(q[:, 0] > CLIFF, torch.full_like(lp, float("nan")), lp), g

    def dense(k):
        m = rng.normal(size=(k, DIM, DIM))
        minv = m @ np.swapaxes(m, -1, -2) / DIM + np.eye(DIM)
        chol = np.linalg.cholesky(minv)
        return [torch.as_tensor(x) for x in (minv, chol, np.swapaxes(np.linalg.inv(chol), -1, -2))]

    if metric_kind == "dense":
        metric = DenseMetric(*(x[0] for x in dense(1)))
    elif metric_kind == "rung":
        metric = RungDenseMetric(*dense(4 if c % 4 == 0 else c))
    else:
        metric = DiagMetric(torch.as_tensor(rng.uniform(0.5, 2.0, size=(c, DIM))))
    q = torch.as_tensor(rng.normal(size=(c, DIM)) * 0.5)
    eps = torch.as_tensor(np.geomspace(0.004, 1.5, c) if c > 1 else [0.004])
    return vg, q, eps, metric


def _run(transition, vg, q, eps, metric, n_transitions=3, seed=5):
    """``n_transitions`` transitions from q; every output of each."""
    gen = torch.Generator().manual_seed(seed)
    lp, g = vg(q)
    outs = []
    for _ in range(n_transitions):
        q, lp, g, stats, *div_pair = transition(vg, q, lp, g, eps, metric, gen)
        outs.append([q, lp, g, stats, *div_pair])
    return outs, gen.get_state()


def _assert_same(got, want):
    (outs_got, rng_got), (outs_want, rng_want) = got, want
    assert torch.equal(rng_got, rng_want)
    for a, b in zip(outs_got, outs_want):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if isinstance(x, NutsStats):
                assert (x.host_syncs, x.lockstep_leaves) == (y.host_syncs, y.lockstep_leaves)
                x, y = tuple(x[:6]), tuple(y[:6])
            for s, t in zip(x if isinstance(x, tuple) else (x,), y if isinstance(y, tuple) else (y,)):
                assert s.dtype == t.dtype and s.shape == t.shape
                assert torch.equal(s, t) or torch.equal(s.isnan(), t.isnan()) and torch.equal(
                    s.nan_to_num(), t.nan_to_num())


@pytest.mark.parametrize("max_depth", [10, 3])
@pytest.mark.parametrize("c", [1, 3, 8])
@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("metric_kind", ["dense", "diag", "rung"])
def test_tree_bit_equal_to_reference(metric_kind, track, c, max_depth):
    vg, q, eps, metric = _case(metric_kind, c)

    def new(*args):
        return nb.nuts_transition_batched(*args, max_depth=max_depth, track_div_leaf=track)

    def old(*args):
        return reference_transition(*args, max_depth=max_depth, track_div_leaf=track)

    got, want = _run(new, vg, q, eps, metric), _run(old, vg, q, eps, metric)
    _assert_same(got, want)
    depths = torch.stack([o[3].tree_depth for o in want[0]])
    if max_depth == 3:
        assert int(depths.max()) == 3  # the cap is hit
    elif c > 1:
        assert int(depths.max()) == 10 and int(depths.min()) < 10
    if track and c == 8:
        assert any(bool(o[3].diverging.any()) for o in want[0])


def _replay_eagerly(self, metric, i):
    """The graphed schedule without a card: the doubling runs eagerly and
    the host reads only its readout, as after a replay."""
    self._doubling(metric, i)
    all_done, leaves = self.st.readout.tolist()
    return bool(all_done), leaves


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("metric_kind", ["dense", "diag", "rung"])
def test_graphed_schedule_one_host_read_per_doubling(monkeypatch, metric_kind, track):
    """The card's schedule (a replay per doubling, then one read of the
    done flag and the device's leaf counter) gives the reference's bits and
    leaves, and reads the host once per doubling run."""
    monkeypatch.setattr(nb.LockstepTree, "_replay", _replay_eagerly)
    vg, q, eps, metric = _case(metric_kind, 8, seed=1)
    trees = {}

    def graphed(vg_b, q, lp, g, eps, metric, gen):
        if gen not in trees:
            trees[gen] = nb.LockstepTree(vg_b, gen, 10, track_div_leaf=track, graphed=True)
        return nb.nuts_transition_batched(vg_b, q, lp, g, eps, metric, gen, track_div_leaf=track,
                                          tree=trees[gen])

    got = _run(graphed, vg, q, eps, metric, n_transitions=4)
    want = _run(lambda *a: reference_transition(*a, track_div_leaf=track), vg, q, eps, metric,
                n_transitions=4)
    for o_got, o_want in zip(got[0], want[0]):
        stats, ref = o_got[3], o_want[3]
        assert stats.host_syncs == int(ref.tree_depth.max())
        assert stats.lockstep_leaves == ref.lockstep_leaves
        assert ref.host_syncs > stats.host_syncs
        o_got[3] = ref  # the host counts differ by design; the rest is compared below
    _assert_same(got, want)


class _HostWhile:
    """A WHILE node run by the host: its body again while the condition the
    odd leaves' commits set (``counters[2]``) holds."""

    def __init__(self, st):
        self.st, self.iterations = st, 0

    def handle(self):
        return 0

    def loop(self, handle, body):
        while bool(self.st.counters[leaf.CONDITION]):
            self.iterations += 1
            body()


def _replay_device_schedule(self, metric, i):
    """The card's graph of doubling i without a card: leaves 0 and 1, then
    one pair body while the commit's condition holds, each leaf's index
    from the pair counter; the host reads the readout once. The leaves run
    are twice the pair counter, two per WHILE iteration after the first
    pair."""
    loops = _HostWhile(self.st)
    self._doubling(metric, i, loops)
    all_done, leaves = self.st.readout.tolist()
    assert leaves == (1 if i == 0 else 2 * int(self.st.counters[leaf.K]))
    assert loops.iterations == max(leaves - 2, 0) // 2
    return bool(all_done), leaves


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("metric_kind", ["dense", "diag", "rung"])
def test_device_loop_schedule_gives_the_reference_bits(monkeypatch, metric_kind, track):
    """The WHILE node's schedule (the pair body while k < 2^i / 2 and any
    chain alive, from the plain commit's pair counter and condition) runs
    the reference's leaves: its bits, batched leaves and one host read per
    doubling."""
    monkeypatch.setattr(nb.LockstepTree, "_replay", _replay_device_schedule)
    vg, q, eps, metric = _case(metric_kind, 8, seed=2)
    trees = {}

    def graphed(vg_b, q, lp, g, eps, metric, gen):
        if gen not in trees:
            trees[gen] = nb.LockstepTree(vg_b, gen, 10, track_div_leaf=track, graphed=True)
        return nb.nuts_transition_batched(vg_b, q, lp, g, eps, metric, gen, track_div_leaf=track,
                                          tree=trees[gen])

    got = _run(graphed, vg, q, eps, metric, n_transitions=4)
    want = _run(lambda *a: reference_transition(*a, track_div_leaf=track), vg, q, eps, metric,
                n_transitions=4)
    for o_got, o_want in zip(got[0], want[0]):
        stats, ref = o_got[3], o_want[3]
        assert stats.host_syncs == int(ref.tree_depth.max())
        assert stats.lockstep_leaves == ref.lockstep_leaves
        o_got[3] = ref  # the host counts differ by design; the rest is compared below
    _assert_same(got, want)


def test_graph_path_selection():
    """The graphed tree is chosen for a CUDA device and a value-and-grad
    without a collective (``reduce``), by that property alone."""
    def vg(q):
        return q.sum(-1), q

    class Reduced:
        def __call__(self, q):
            return q.sum(-1), q

        @staticmethod
        def reduce(lp, g):
            return lp, g

    class Graphed:
        reduce = None
        eager = staticmethod(vg)

    assert nb.tree_graphed("cuda", vg) and nb.tree_graphed(torch.device("cuda", 1), Graphed())
    assert not nb.tree_graphed("cpu", vg) and not nb.tree_graphed(torch.device("cpu"), Graphed())
    assert not nb.tree_graphed("cuda", Reduced())
    cpu = nb.LockstepTree(Graphed(), torch.Generator())
    assert not cpu.graphed and cpu.leaf_vg is not vg
    forced = nb.LockstepTree(Graphed(), torch.Generator(), graphed=True)
    assert forced.leaf_vg is vg  # a graph captures the eager function, never a replay


def test_when_branches_on_the_host_eagerly():
    ran = []
    assert nb._when(torch.tensor(True), lambda: ran.append(1)) and ran == [1]
    assert not nb._when(torch.tensor(False), lambda: ran.append(2)) and ran == [1]
    assert nb._when(torch.tensor([True, False]).any(), lambda: ran.append(3)) and ran == [1, 3]


def test_graph_inputs_are_rewritten_in_place():
    """Under the graphed tree the step sizes and the metric the doublings
    read are the tree's own buffers, rewritten in place at every call (a
    graph reads them by address), in the caller's layout; the eager tree
    reads the caller's."""
    vg, q, eps, metric = _case("dense", 3)
    metric = DenseMetric(*(t.contiguous() for t in metric))  # row-major
    tree = nb.LockstepTree(vg, torch.Generator(), graphed=True)
    bound = tree._bind(q, eps, metric)
    buffers = [t.data_ptr() for t in (tree.st.eps, *bound)]
    again = tree._bind(q, 2 * eps, DenseMetric(*(2 * t for t in metric)))
    assert again is bound and [t.data_ptr() for t in (tree.st.eps, *again)] == buffers
    assert torch.equal(tree.st.eps, 2 * eps) and torch.equal(again.minv, 2 * metric.minv)
    # a factor in another layout (column-major) gets a copy in that layout:
    # the card's products round by their operands' layout
    col_major = DenseMetric(metric.minv, metric.chol_minv, metric.p_chol.T.contiguous().T)
    moved = tree._bind(q, eps, col_major)
    assert moved is not bound and moved.p_chol.stride() == col_major.p_chol.stride()
    assert torch.equal(moved.p_chol, metric.p_chol)
    eager = nb.LockstepTree(vg, torch.Generator())
    assert eager._bind(q, eps, metric) is metric


def _count_trees(monkeypatch):
    made = []
    real = nb.LockstepTree.__init__

    def init(self, *args, **kwargs):
        made.append(kwargs.get("track_div_leaf", False))
        real(self, *args, **kwargs)

    monkeypatch.setattr(nb.LockstepTree, "__init__", init)
    return made


def _gauss_vg(q):
    return -0.5 * (q * q).sum(-1), -q


@pytest.mark.parametrize("mass_matrix", ["dense-pooled", "diag"])
def test_run_chains_keeps_one_tree(monkeypatch, mass_matrix):
    """Warmup and sampling run on one tree (one set of graphs on the card)."""
    made = _count_trees(monkeypatch)
    _, info = tc.run_chains(_gauss_vg, torch.zeros((4, 3), dtype=torch.float64),
                            torch.Generator().manual_seed(0), n_samples=30, n_adapts=15,
                            max_depth=4, mass_matrix=mass_matrix, chunk_size=10)
    assert made == [False] and info["transitions"] == 30


def test_envelope_warmup_runs_its_own_tracked_tree(monkeypatch):
    made = _count_trees(monkeypatch)
    env = tc.CurvatureEnvelope(lambda z: np.eye(z.shape[0]))
    tc.run_chains(_gauss_vg, torch.zeros((4, 3), dtype=torch.float64),
                  torch.Generator().manual_seed(0), n_samples=20, n_adapts=10, max_depth=4,
                  envelope=env)
    assert sorted(made) == [False, True]


def test_parallel_tempering_keeps_one_tree(monkeypatch):
    made = _count_trees(monkeypatch)
    _, info = tt.run_parallel_tempering(_gauss_vg, torch.zeros(3, dtype=torch.float64),
                                        torch.Generator().manual_seed(0), n_samples=20,
                                        n_adapts=10, n_temps=3, max_depth=4)
    assert made == [False] and info["transitions"] == 20


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc; run on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_doubling_graphs_hold_at_most_four_leaves(cuda_device):
    """On the card every doubling's graph captures min(2^i, 4) leaves, from
    depth 2 the pairs under one WHILE node (no per-pair condition), so the
    graphs of depths 2-9 have the same nodes, with one D1 and one D2 each
    around one L2 a captured leaf; a transition on them gives the eager
    tree's bits."""
    def vg(q):
        return -0.5 * (q * q).sum(-1), -q

    c, dim = 8, 5
    q = torch.as_tensor(np.random.default_rng(0).normal(size=(c, dim)), device=cuda_device)
    eps = torch.as_tensor(np.geomspace(0.004, 1.5, c), device=cuda_device)
    eye = torch.eye(dim, dtype=torch.float64, device=cuda_device)
    metric = DenseMetric(eye, eye, eye)
    tree = nb.LockstepTree(vg, torch.Generator(device=cuda_device).manual_seed(1), 10,
                           graphed=True)
    bound = tree._bind(q, eps, metric)
    for i in range(10):
        tree.graphs[i] = tree._capture(bound, i)
    info = tree.graph_info
    assert [info[i]["captured_leaves"] for i in range(10)] == [1, 2] + [4] * 8
    assert [info[i]["while_nodes"] for i in range(10)] == [0, 0] + [1] * 8
    assert len({info[i]["nodes"] + info[i]["body_nodes"] for i in range(2, 10)}) == 1
    assert all(info[i]["leaf_launches"] == {leaf.OPEN: 1, leaf.COMMIT: min(1 << i, 4),
                                            leaf.MERGE: 1} for i in range(10))
    outs = {}
    for graphed in (True, False):
        gen = torch.Generator(device=cuda_device).manual_seed(3)
        t = nb.LockstepTree(vg, gen, 10, graphed=graphed)
        outs[graphed] = t(q, *vg(q), eps, metric)
    for a, b in zip(outs[True][:3], outs[False][:3]):
        assert torch.equal(a, b)
    assert outs[True][3].lockstep_leaves == outs[False][3].lockstep_leaves
