"""Batched NUTS transition over an explicit (C, dim) chain axis (port of
the JAX package's inference/nuts_batched.py).

Per chain the semantics are those of the JAX package: multinomial
trajectory sampling, biased progressive sampling across doublings, the
generalized U-turn criterion with the checkpointed sub-tree checks of
iterative NUTS, divergence at MAX_DELTA_ENERGY. The metric is a
``nuts.DenseMetric`` shared by all chains (``p @ minv.T``, momenta drawn as
``z @ p_chol.T``) or a per-chain ``nuts.DiagMetric`` (``inv_mass * p``,
``z / sqrt(inv_mass)``); the tree code only calls its ``momentum`` and
``velocity``.

The JAX package keeps both lockstep loops on the device: the doublings
run while any chain is not done and, inside a doubling, the leaves while
any chain is alive (two ``lax.while_loop``s). Here a doubling of depth i is
one function (``LockstepTree._doubling``) over a tree state held in
preallocated (C, ...) buffers that it updates in place. Its 2^i leaves run
in pairs (2k, 2k+1); pair k >= 1 runs only if some chain is still alive,
which is the JAX leaf loop's condition read where its U-turn checks run.
That one function runs two ways:

- on the card it is captured lazily into one CUDA graph per depth, with
  the value-and-grad's own eager function inside it: leaves 0 and 1, then
  (from depth 2) one WHILE node whose body is one pair
  (``ops/graph_if.py``). The leaf index is a device counter: the commit
  kernel of each odd leaf advances the pair counter and sets the node's
  condition, k < 2^i / 2 and any chain alive (``ops/leaf.py``, L2), so the
  device runs exactly the pairs the eager loop runs, and a doubling's graph
  holds at most four leaves whatever its depth. The host replays one graph
  per doubling and reads the done flags and the leaves run (a device
  counter) once after it, so a transition of d doublings costs d host
  reads;
- eagerly (on the CPU, and on the card for a value-and-grad that ends in a
  collective, which a graph cannot capture: ``tree_graphed``) the host
  reads ``alive.any()`` before each pair k >= 1 and ``done.all()`` after
  each doubling but the last possible one, about L/2 + d reads for L
  batched leaves. On the CPU the checkpoint rows a leaf writes or checks
  (popcount(j >> 1)) are the host's constants of the leaf.

Both make the same draws and the same arithmetic, so they give the same
bits. ``NutsStats.host_syncs`` counts the reads.

Leaf state is packed as one (C, 5, dim) tensor [q, p, v, grad, M^-1 grad]
so that each masked commit is one ``torch.where``. A doubling's bookkeeping
is ``ops/leaf.py``'s: on the card three hand-written kernels, the opening D1
(the direction, the edge, the sub-tree's reset and leaf 0's position), per
leaf the commit L2 after the value-and-grad (what the JAX package's fused
leaf body does after the value-and-grad, and then the next leaf's
position), and the merge D2 (the sub-tree into the trajectory, and the
readout); on the CPU their plain versions. Random numbers come from
one ``torch.Generator`` on the chains' device: per transition the momenta
(drawn eagerly), per doubling a direction and a subtree-merge uniform
(2, C) and one uniform per leaf (2^i, C), drawn inside the doubling's
graph, whose replays advance the generator as the eager draws do.

``track_div_leaf`` (the curvature envelope's warmup, parallel/chains.py)
also records each chain's last divergent leapfrog step: the position it was
taken from (its edge) and the exploded leaf it produced. Off, the
transition issues exactly the operations it issues without the option; on,
it adds two masked copies per leaf and draws the same numbers.

While the tracer is on (``utils/trace.py``) a transition records host
spans: ``transition`` around it, ``transition.prologue`` (the binding, the
momentum draw and products, the tree's reset), per doubling
``doubling.launch`` (the graph's replay, or the eager doubling),
``doubling.readout`` (the host read, counting the leaves run) and, for a
graph, ``doubling.bookkeeping`` (the launch tables), ``tree.capture`` around a
capture, and ``transition.stats`` (``NutsStats`` and the outputs' copies);
on the card the prologue, each replay and the stats also record CUDA
events, and the graphs captured while it is on carry its stage stamps: a
leaf's value-and-grad is captured in a ``vg`` stage scope and its metric
product in a ``metric`` one (``ops/leaf.py``). Off, the tree records and
launches nothing more.

Under a chain mesh (``parallel/mesh.py``) each rank runs the transition of
its block of chains in its own lockstep. Every rank draws each random
tensor for all chains and keeps its block (``mesh.local_draw``), and at the
end of a transition a rank that stopped doubling before the deepest rank
makes the draws of the doublings it skipped (one ``max`` over the ranks per
transition), so the generators stay in step and chain c draws what it
would draw unsharded.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops import cuda_band, minv_mv
from ..ops import leaf as leaf_ops
from ..parallel.mesh import local_draw
from ..utils import trace
from .adapt import da_init, da_restart, da_update
from .nuts import (
    MAX_DELTA_ENERGY,
    ChainState,
    DenseMetric,
    NutsStats,
    SampleCarry,
    WarmupCarry,
    _leaf_idx_to_ckpt_idxs,
)

# rows of the packed leaf state
Q, P, V, G, MG = range(5)


def tree_graphed(device, vg_b) -> bool:
    """Whether a tree on ``device`` for ``vg_b`` runs as CUDA graphs: on a
    CUDA device, unless the value-and-grad ends in a collective (a
    ``reduce``, parallel/grid.py), which a graph cannot capture; that one
    keeps the eager tree."""
    return torch.device(device).type == "cuda" and getattr(vg_b, "reduce", None) is None


def kernel_launch_counts() -> dict:
    """The launch counts that a captured graph moves to its replays (a
    doubling's once per leaf): the value-and-grad's kernels
    (``ops/cuda_band``: by entry point and tile) and the product kernel's
    and its preparation's (``ops/minv_mv``: the dense metric's M^-1 g, the
    whitening GEMMs)."""
    return {**cuda_band.counts(), **minv_mv.LAUNCHES}


def add_kernel_launches(added: dict) -> None:
    """Add launches, named as ``kernel_launch_counts`` names them."""
    minv_mv.add_launches({k: n for k, n in added.items() if k in minv_mv.LAUNCHES})
    cuda_band.add_launches({k: n for k, n in added.items() if k not in minv_mv.LAUNCHES})


def _when(pred: torch.Tensor, body: Callable[[], None]) -> bool:
    """Run ``body()`` if the one-element bool ``pred`` holds, read on the
    host (the eager tree's leaf loop). Returns False if it skipped it."""
    if not bool(pred):
        return False
    body()
    return True


class _TreeState:
    """The transition's buffers, (C, ...) on the chains' device, updated in
    place: the trajectory (``left``, ``right``, ``rho``, ``prop`` ...), the
    sub-tree a doubling builds (``cur``, ``s_*``, ``alive``,
    ``ckpts`` = [p, v, rho] per checkpoint row, ``q`` the two positions a
    leaf's value-and-grad reads, by the leaf's parity: the commit of leaf j
    writes leaf j + 1's into the other), ``readout`` = (all chains done,
    leaves run by the last doubling) and, with ``counters``, the leaf
    kernel's (3,) int32 [pair counter, blocks arrived, the leaf loop's
    condition] (``ops/leaf.py``). ``half`` and ``step`` are the signed steps
    D1 writes on the card."""

    def __init__(self, c, dim, dtype, device, max_depth, track, counters):
        self.key = (c, dim, dtype, device)
        f = dict(dtype=dtype, device=device)
        b = dict(dtype=torch.bool, device=device)
        self.eps, self.h0, self.half, self.step = (torch.zeros(c, **f) for _ in range(4))
        self.left, self.right, self.prop, self.cur, self.s_prop = (
            torch.zeros((c, 5, dim), **f) for _ in range(5))
        self.rho, self.s_rho = torch.zeros((c, dim), **f), torch.zeros((c, dim), **f)
        self.q = torch.zeros((2, c, dim), **f)
        (self.logp_prop, self.log_sum_w, self.sum_accept, self.num_leaves, self.s_logp_prop,
         self.s_lsw, self.s_sum_accept, self.s_n_leaves) = (torch.zeros(c, **f) for _ in range(8))
        self.diverging, self.done, self.s_div, self.s_turn, self.alive = (
            torch.zeros(c, **b) for _ in range(5))
        self.depth = torch.zeros(c, dtype=torch.int32, device=device)
        self.ckpts = torch.zeros((c, max(max_depth - 1, 1), 3, dim), **f)
        self.readout = torch.zeros(2, dtype=torch.int64, device=device)
        self.counters = torch.zeros(3, dtype=torch.int32, device=device) if counters else None
        if track:
            self.div_edge, self.div_leaf, self.s_div_edge, self.s_div_leaf = (
                torch.zeros((c, dim), **f) for _ in range(4))


class LockstepTree:
    """The NUTS transition of C chains (``nuts_transition_batched``) over
    a tree state that persists across calls, for one value-and-grad
    ``vg_b`` (C, dim) -> ((C,), (C, dim)), ``generator``, ``max_depth``,
    ``max_delta_energy``, chain ``mesh`` and ``track_div_leaf``. See the
    module docstring.

    ``graphed`` (default ``tree_graphed(generator.device, vg_b)``): run each
    doubling as a CUDA graph captured at its first use (``graphs``, by
    depth; ``graph_info`` has each one's top-level and WHILE-body node
    counts, WHILE nodes, captured leaves, capture seconds and memory-pool
    bytes). The graph captures
    ``vg_b.eager`` where ``vg_b`` has one (a ``GraphedValueAndGrad``'s own
    function: a replay cannot be captured), and reads by address the
    tree's copies of the step sizes and the metric, which each call writes
    in place. The launches that come once per leaf (the value-and-grad's
    kernels, ``ops/cuda_band``; the dense metric's product,
    ``ops/minv_mv``) are counted at the first capture, per leaf, and each
    replay adds them times the leaves it ran; the doubling's kernels
    likewise (``ops/leaf``: one D1 and one D2 per replay, one L2 per leaf).
    A capture or a replay that fails raises."""

    def __init__(self, vg_b, generator: torch.Generator, max_depth: int = 10,
                 max_delta_energy: float = MAX_DELTA_ENERGY, mesh=None,
                 track_div_leaf: bool = False, graphed: Optional[bool] = None):
        self.vg_b, self.generator, self.mesh = vg_b, generator, mesh
        self.max_depth, self.max_delta_energy = int(max_depth), max_delta_energy
        self.track = bool(track_div_leaf)
        self.graphed = tree_graphed(generator.device, vg_b) if graphed is None else bool(graphed)
        self.leaf_vg = getattr(vg_b, "eager", vg_b) if self.graphed else vg_b
        self.st = self.metric = None
        self.loops = self.pool = self.stream = None  # of the graphs, made at the first capture
        self.graphs, self.graph_info = {}, {}
        self.per_leaf = None  # the kernel launches per leaf in a graph (kernel_launch_counts)

    @property
    def capture_seconds(self) -> float:
        """Host seconds spent capturing this tree's graphs."""
        return sum(info["capture_s"] for info in self.graph_info.values())

    # -- the state ----------------------------------------------------------

    def _bind(self, q, step_size, metric):
        """The state buffers for q's shape (new ones drop the graphs), the
        step sizes written in; the metric the doublings read: the caller's
        when eager, else the tree's copy, rewritten in place, and with it
        a dense metric's prepared product operand (``ops/minv_mv.prepared``:
        one launch a transition)."""
        c, dim = q.shape
        key = (c, dim, q.dtype, q.device)
        if self.st is None or self.st.key != key:
            self.st = _TreeState(c, dim, q.dtype, q.device, self.max_depth, self.track,
                                 counters=self.graphed or q.device.type == "cuda")
            self.graphs.clear()
        self.st.eps.copy_(torch.as_tensor(step_size, dtype=q.dtype, device=q.device).expand(c))
        if not self.graphed:
            return metric
        # the copies keep the caller's layout (a product's rounding on the
        # card follows it); an expanded tensor (a shared diagonal) is copied
        # whole, which only elementwise products read
        if (type(metric) is not type(self.metric)
                or any(a.shape != b.shape or a.dtype != b.dtype
                       or (a.stride() != b.stride() and 0 not in b.stride())
                       for a, b in zip(self.metric, metric))):
            self.metric = type(metric)(*(t.clone() for t in metric))
            self.graphs.clear()
            self.per_leaf = None
        else:
            for buf, t in zip(self.metric, metric):
                buf.copy_(t)
        if isinstance(self.metric, DenseMetric):
            minv_mv.prepared(self.metric.minv)
        return self.metric

    # -- one leaf, one doubling ------------------------------------------------

    def _leaf(self, metric, half, step, u_leaf, j: int, handle=None) -> None:
        """Leapfrog step j of the sub-tree from ``cur``, committed for the
        chains alive (``ops/leaf.py``: the value-and-grad at ``st.q[j % 2]``,
        which the doubling's opening wrote for leaf 0 and the commit of leaf
        j - 1 for the others, and the commit, on the card L2, which takes
        the leaf index from the pair counter, sets ``handle``'s condition and
        writes the next leaf's position into ``st.q[1 - j % 2]``; on the CPU
        its plain version)."""
        st = self.st
        q_n, q_next = st.q[j % 2], st.q[1 - j % 2]
        with trace.stage(trace.VG):
            logp_n, g_n = self.leaf_vg(q_n)
        leaf_ops.leaf_commit(st, metric, half, step, q_n, q_next, logp_n, g_n, u_leaf, j,
                             _leaf_idx_to_ckpt_idxs(j), self.max_delta_energy, self.track,
                             handle)

    def _doubling(self, metric, i: int, loops=None):
        """Doubling i: a sub-tree of 2^i leaves in a random direction from
        the trajectory's edge, merged into the trajectory: its draws, its
        opening, its leaves and its merge (``ops/leaf.py``: on the card D1,
        L2 per leaf and D2). ``loops`` (under capture,
        ``ops/graph_if.WhileNodes``): the pairs after the first run under one
        WHILE node whose condition the odd leaves' commits set. Returns the
        leaves run and the host reads made (both meaningful when eager)."""
        st = self.st
        c = st.done.shape[0]
        dtype, device = st.eps.dtype, st.eps.device
        n_leaves = 1 << i
        u = local_draw(torch.rand, self.generator, (2, c), 1, self.mesh, dtype, device)
        # contiguous: a mesh's block of columns is copied out of the full draw
        u_leaf = local_draw(torch.rand, self.generator, (n_leaves, c), 1, self.mesh, dtype,
                            device).contiguous()
        half, step = leaf_ops.doubling_open(st, u, n_leaves, self.track)
        handle = loops.handle() if loops is not None and n_leaves >= 4 else None

        def pair(k):
            self._leaf(metric, half, step, u_leaf, 2 * k, handle)
            self._leaf(metric, half, step, u_leaf, 2 * k + 1, handle)

        leaves = min(n_leaves, 2)
        for j in range(leaves):
            self._leaf(metric, half, step, u_leaf, j, handle)
        reads = 0
        if handle is not None:
            # the device's loop: each pair's leaf index from the pair counter
            loops.loop(handle, lambda: pair(1))
        else:
            for k in range(1, n_leaves // 2):
                reads += 1
                if not _when(st.alive.any(), lambda k=k: pair(k)):
                    break
                leaves += 2
        leaf_ops.doubling_merge(st, u, n_leaves, i + 1, self.track)
        return leaves, reads

    # -- the CUDA graphs -------------------------------------------------------

    def _capture(self, metric, i: int) -> torch.cuda.CUDAGraph:
        """Capture doubling i into a CUDA graph (no kernel runs): leaves 0
        and 1, and from depth 2 one WHILE node whose body is one leaf pair,
        so min(2^i, 4) leaves. Its per-leaf launches (``kernel_launch_counts``:
        the value-and-grad's kernels and the dense metric's product) are
        taken back out of their counts and must be ``per_leaf`` times the
        captured leaves, and its doubling kernels' out of ``ops/leaf``'s:
        exactly one D1, one D2 and one L2 per captured leaf (recorded in
        ``graph_info`` as ``leaf_launches``)."""
        from ..ops import graph_if

        device = self.st.eps.device
        if self.loops is None:
            self.loops = graph_if.WhileNodes(device)
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(device)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        before, body_before = kernel_launch_counts(), self.loops.body_nodes
        leaf_before = dict(leaf_ops.LAUNCHES)
        with trace.timed("tree.capture") as timed:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                self._doubling(metric, i, self.loops)
                nodes = graph_if.capture_nodes(self.stream)
            # Before the capture begins, PyTorch writes the registered
            # generator's graph offset (0) on the capture stream, outside the
            # graph; each replay writes the generator's current offset on the
            # replaying stream. Unordered, the capture's write could land
            # after the first replay's and that replay draw from offset 0:
            # other draws whenever the card is busy, as with several ranks on
            # it (PERF.md, Findings).
            torch.cuda.current_stream(device).wait_stream(self.stream)
        seconds = timed.seconds
        launches = {name: k - before[name] for name, k in kernel_launch_counts().items()}
        add_kernel_launches({name: -k for name, k in launches.items()})
        leaf_launches = {name: k - leaf_before[name] for name, k in leaf_ops.LAUNCHES.items()}
        leaf_ops.LAUNCHES.update(leaf_before)
        captured = min(1 << i, 4)
        if leaf_launches != {leaf_ops.OPEN: 1, leaf_ops.COMMIT: captured, leaf_ops.MERGE: 1}:
            raise RuntimeError(f"doubling {i}'s graph captured {leaf_launches} doubling-kernel "
                               f"launches, not one D1, one D2 and one L2 per captured leaf "
                               f"({captured})")
        if self.per_leaf is None:
            self.per_leaf = {name: k // captured for name, k in launches.items()}
        if any(k != self.per_leaf[name] * captured for name, k in launches.items()):
            raise RuntimeError(f"doubling {i}'s graph captured {launches} kernel launches, "
                               f"not {self.per_leaf} per leaf times {captured}")
        pools = (self.pool, self.loops.pool)
        pool_bytes = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                         if tuple(seg.get("segment_pool_id", ())) in pools)
        self.graph_info[i] = dict(nodes=nodes, body_nodes=self.loops.body_nodes - body_before,
                                  while_nodes=int(captured == 4), captured_leaves=captured,
                                  leaf_launches=leaf_launches, capture_s=seconds,
                                  pool_bytes=pool_bytes)
        return graph

    def _replay(self, metric, i: int):
        """Doubling i from its graph, then one host read: (all chains done,
        leaves run)."""
        graph = self.graphs.get(i)
        if graph is None:
            graph = self.graphs[i] = self._capture(metric, i)
        with trace.device_span("doubling.launch", "graph"):
            graph.replay()
        with trace.span("doubling.readout") as read:
            all_done, leaves = self.st.readout.tolist()
            read.count(leaves)
        with trace.span("doubling.bookkeeping"):
            add_kernel_launches({name: k * leaves for name, k in self.per_leaf.items()})
            leaf_ops.LAUNCHES[leaf_ops.OPEN] += 1
            leaf_ops.LAUNCHES[leaf_ops.COMMIT] += leaves
            leaf_ops.LAUNCHES[leaf_ops.MERGE] += 1
        return bool(all_done), leaves

    def _eager(self, metric, i: int):
        """Doubling i run eagerly, then the host read of done (but after the
        last possible doubling): (all chains done, leaves run, host reads)."""
        with trace.span("doubling.launch"):
            leaves, reads = self._doubling(metric, i)
        with trace.span("doubling.readout") as read:
            all_done = False
            if i + 1 < self.max_depth:
                reads += 1
                all_done = bool(self.st.done.all())
            read.count(leaves)
        return all_done, leaves, reads

    # -- the transition ----------------------------------------------------------

    def __call__(self, q, logp, grad, step_size, metric):
        """One transition from (q (C, dim), logp (C,), grad (C, dim)) at
        ``step_size`` (scalar or (C,)) under ``metric``; returns as
        ``nuts_transition_batched``."""
        with trace.span("transition"):
            return self._transition(q, logp, grad, step_size, metric)

    def _transition(self, q, logp, grad, step_size, metric):
        c, dim = q.shape
        dtype, device = q.dtype, q.device
        with trace.device_span("transition.prologue"):
            metric = self._bind(q, step_size, metric)
            st = self.st
            z = local_draw(torch.randn, self.generator, (c, dim), 0, self.mesh, dtype, device)
            p0 = metric.momentum(z)
            v0 = metric.velocity(p0)
            st.h0.copy_(-logp + 0.5 * leaf_ops.rowdot(p0, v0))
            torch.stack([q, p0, v0, grad, metric.velocity(grad)], dim=1, out=st.left)
            st.right.copy_(st.left)
            st.prop.copy_(st.left)
            st.rho.copy_(p0)
            st.logp_prop.copy_(logp)
            for buf in (st.log_sum_w, st.sum_accept, st.num_leaves, st.diverging, st.depth,
                        st.done):
                buf.zero_()
            if self.track:
                st.div_edge.zero_()
                st.div_leaf.zero_()

        host_syncs = lockstep_leaves = doublings = 0
        for i in range(self.max_depth):
            doublings += 1
            if self.graphed:
                all_done, leaves = self._replay(metric, i)
                host_syncs += 1
            else:
                all_done, leaves, reads = self._eager(metric, i)
                host_syncs += reads
            lockstep_leaves += leaves
            if all_done:
                break

        if self.mesh is not None:
            # the draws of the doublings the deepest rank ran and this one did not
            host_syncs += 1
            full = c * self.mesh.size
            for i in range(doublings, self.mesh.max_int(doublings)):
                torch.rand((2, full), generator=self.generator, dtype=dtype, device=device)
                torch.rand((1 << i, full), generator=self.generator, dtype=dtype, device=device)

        with trace.device_span("transition.stats"):
            stats = NutsStats(
                accept_prob=st.sum_accept / torch.clamp(st.num_leaves, min=1.0),
                num_leapfrog=st.num_leaves.clone(),
                tree_depth=st.depth.clone(),
                diverging=st.diverging.clone(),
                energy=st.h0.clone(),
                step_size=st.eps.clone(),
                host_syncs=host_syncs,
                lockstep_leaves=lockstep_leaves,
            )
            out = (st.prop[:, Q].clone(), st.logp_prop.clone(), st.prop[:, G].clone(), stats)
            if self.track:
                out = (*out, (st.div_edge.clone(), st.div_leaf.clone()))
        return out


def nuts_transition_batched(
    vg_b: Callable,
    q: torch.Tensor,         # (C, dim)
    logp: torch.Tensor,      # (C,)
    grad: torch.Tensor,      # (C, dim)
    step_size,               # scalar or (C,)
    metric,                  # DenseMetric, RungDenseMetric or DiagMetric
    generator: torch.Generator,
    max_depth: int = 10,
    max_delta_energy: float = MAX_DELTA_ENERGY,
    mesh=None,
    track_div_leaf: bool = False,
    tree: Optional[LockstepTree] = None,
):
    """One NUTS transition for all C chains under ``metric``.
    ``vg_b`` maps (C, dim) -> ((C,), (C, dim)). Under a chain ``mesh`` the
    C chains are this rank's block (see the module docstring). Returns
    (q', logp', grad', NutsStats), and with ``track_div_leaf`` a fifth
    output: (edge, leaf), each (C, dim), the two endpoints of each chain's
    divergent leapfrog step (zeros for a chain that did not diverge).

    ``tree``: a ``LockstepTree`` made with these ``vg_b``, ``generator``,
    ``max_depth``, ``max_delta_energy``, ``mesh`` and ``track_div_leaf``,
    whose buffers (and, on the card, CUDA graphs) the samplers keep across
    transitions; None runs a new tree eagerly."""
    if tree is None:
        tree = LockstepTree(vg_b, generator, max_depth, max_delta_energy, mesh, track_div_leaf,
                            graphed=False)
    elif (tree.vg_b is not vg_b or tree.generator is not generator or tree.mesh is not mesh
          or (tree.max_depth, tree.max_delta_energy, tree.track)
          != (max_depth, max_delta_energy, track_div_leaf)):
        raise ValueError("nuts_transition_batched: the tree was made for another transition")
    return tree(q, logp, grad, step_size, metric)


# ---------------------------------------------------------------------------
# Warmup under the shared dense metric; sampling under either metric
# ---------------------------------------------------------------------------


def init_warmup_carry_batched(vg_b, q0s: torch.Tensor, initial_step_size) -> WarmupCarry:
    """Evaluate the start positions and start per-chain dual averaging."""
    logp0, grad0 = vg_b(q0s)
    eps0 = torch.full((q0s.shape[0],), float(initial_step_size), dtype=q0s.dtype,
                      device=q0s.device)
    return WarmupCarry(chain=ChainState(q=q0s, logp=logp0, grad=grad0), da=da_init(eps0))


def make_warmup_step_pooled_batched(
    vg_b, target_accept: float, max_depth: int, generator: torch.Generator, mesh=None,
    track_div_leaf: bool = False, tree: Optional[LockstepTree] = None,
):
    """Warmup transition with per-chain dual averaging of the step size
    (restarted at adaptation-window ends) under the shared metric, which
    the driver re-estimates between windows. Returns (carry, stats), and
    with ``track_div_leaf`` also the divergent step's (edge, leaf). The
    transitions run on ``tree`` (a new ``LockstepTree`` by default)."""
    if tree is None:
        tree = LockstepTree(vg_b, generator, max_depth, mesh=mesh, track_div_leaf=track_div_leaf)

    def warmup_step(carry: WarmupCarry, win_end: bool, metric):
        chain = carry.chain
        with trace.span("warmup.transition"):
            q, logp, grad, stats, *div_pair = nuts_transition_batched(
                vg_b, chain.q, chain.logp, chain.grad, torch.exp(carry.da.log_eps),
                metric, generator, max_depth=max_depth, mesh=mesh,
                track_div_leaf=track_div_leaf, tree=tree,
            )
            da = da_update(carry.da, stats.accept_prob, target_accept)
        if win_end:
            da = da_restart(da)
        return (WarmupCarry(chain=ChainState(q=q, logp=logp, grad=grad), da=da), stats,
                *div_pair)

    return warmup_step


def make_sample_step_batched(vg_b, max_depth: int, generator: torch.Generator, mesh=None,
                             tree: Optional[LockstepTree] = None):
    """Post-warmup transition at the frozen per-chain step sizes, scaled by
    an optional step-size multiplier shared by all chains (``step_jitter``
    in parallel/chains.py), under ``metric``, on ``tree`` (a new
    ``LockstepTree`` by default)."""
    if tree is None:
        tree = LockstepTree(vg_b, generator, max_depth, mesh=mesh)

    def sample_step(carry: SampleCarry, eps_mult, metric):
        with trace.span("sample_step"):
            chain = carry.chain
            eps = carry.eps if eps_mult is None else carry.eps * eps_mult
            q, logp, grad, stats = nuts_transition_batched(
                vg_b, chain.q, chain.logp, chain.grad, eps, metric, generator,
                max_depth=max_depth, mesh=mesh, tree=tree,
            )
            return carry._replace(chain=ChainState(q=q, logp=logp, grad=grad)), (q, logp, stats)

    return sample_step
