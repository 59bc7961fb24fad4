"""The NUTS leaf of the batched tree: two hand-written CUDA kernels
(csrc/nuts_leaf.cu), their plain versions and the dispatch between them.

Counterpart of the JAX package's leaf body in inference/nuts_batched.py
(the body of ``_build_subtree_b``'s ``lax.while_loop``, :225-302, with
``_leapfrog_b``, ``_rowdot`` (``rowdot`` here), ``_is_iterative_turning_b`` and
``_row_update``), which XLA compiles into a few fused loops. A leaf of
``inference/nuts_batched.LockstepTree`` is

    if j == 0:
        leaf_drift(st.cur, half, step, out=q_n)           # L1
    logp_n, g_n = vg(q_n)
    leaf_commit(st, metric, half, step, q_n, q_next, logp_n, g_n, u_leaf, j, (lo, hi),
                max_delta_energy, track, handle)          # L2

over the tree's buffers ``st`` (``cur`` (C, 5, dim) = [q, p, v, grad,
M^-1 grad], ``s_prop``, ``first``, ``s_rho``, ``ckpts`` (C, R, 3, dim),
the (C,) sums and flags ``s_lsw``, ``s_logp_prop``, ``s_sum_accept``,
``s_n_leaves``, ``s_div``, ``s_turn``, ``alive``, ``h0``, with ``track``
``s_div_edge``, ``s_div_leaf``, and on the card ``counters``), updated in
place. ``u_leaf`` (2^i, C) are the doubling's uniforms, j the leaf's index
and (lo, hi) its checkpoint rows (``nuts._leaf_idx_to_ckpt_idxs``; hi is the
row an even leaf writes).

L1 runs at leaf 0 of a doubling only. The step is a constant of the
doubling, so the commit of leaf j also writes the next leaf's position,
``q_next`` = L1 of the leaf state it has committed, for every chain (a chain
that is not alive keeps its state, and its q_next is what L1 would write):
the next leaf's value-and-grad reads the bits it read after L1. The tree
alternates two q buffers by the leaf's parity (``st.q[j % 2]`` is q_n,
``st.q[1 - j % 2]`` q_next), so a commit never writes the q_n it reads.

On the card the leaf index is on the device, as the JAX package's leaf
counter is a scalar of its loop: ``st.counters`` = [k, blocks arrived,
condition] (int32), k the doubling's pair counter, zeroed by its setup. L2
takes the leaf's parity and j == 0 (constants of a graph's capture), derives
j = 2k + parity, its rows and its uniform u_leaf[j] (``device_rows`` is the
same arithmetic in Python), and on an odd leaf advances k and sets the leaf
loop's condition ``k < 2^i / 2 and any(alive)``: into ``counters[2]`` and,
given the handle of a WHILE node (``ops/graph_if.py``), into the handle, so
that the node runs the doubling's next leaf pair or ends. The plain version
keeps the host's j; given ``counters`` it takes j from them and advances and
sets them alike (the CPU tree gives none).

On a CUDA tensor the dispatch launches the kernels on the current stream
(so that a CUDA graph captures them, inside a WHILE node's body too): L1
``nuts_leaf_drift`` and L2 ``nuts_leaf_commit``, between them the
value-and-grad and, for a dense or per-rung metric, its product
``metric.velocity(g_n)`` (a dense metric's: the kernel of ``ops/minv_mv.py``;
a per-rung one's an einsum); a diagonal metric's product is L2's. A failed
build or launch raises: there is no fallback. On a CPU tensor it runs the plain versions,
``leaf_drift_torch`` and ``leaf_commit_torch``, which issue the tree's
operations of the leaf in their order, and which the card's kernels are held
against (``chip_smoke.py``'s [leaf]).

``LAUNCHES`` counts each kernel's launches: a wrapper adds one per launch,
and the tree moves the launches its CUDA graphs captured to each replay
(``LockstepTree._capture``, ``_replay``): one L1 per doubling, one L2 per
leaf run.

The source is compiled at first use with nvcc for sm_90a into
``<package>/build/`` (``ops/cuda_band.build``) and bound with ctypes.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from . import cuda_band

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "nuts_leaf.cu"
DRIFT, COMMIT = "nuts_leaf_drift", "nuts_leaf_commit"
# L2's pointer arguments, in the order of the kernel's CommitArgs
COMMIT_POINTERS = ("cur", "q_n", "q_next", "logp_n", "g_n", "mg_n", "inv_mass", "half", "step",
                   "h0", "u_leaf", "s_prop", "s_logp_prop", "s_rho", "first", "ckpts", "s_lsw",
                   "s_sum_accept", "s_n_leaves", "s_div", "s_turn", "alive", "s_div_edge",
                   "s_div_leaf", "counters")
# L2's integer arguments, in the order of the kernel's CommitArgs, then the
# two counts the kernel checks against its own
COMMIT_INTS = ("n_chains", "dim", "n_rows", "inv_mass_stride", "n_leaves", "parity",
               "is_first", "has_handle", "handle", "n_pointers", "n_ints")
N_COMMIT_INTS = len(COMMIT_INTS)
# st.counters: the pair counter, the blocks arrived, the leaf loop's condition
K, ARRIVED, CONDITION = range(3)

# Kernel launches since the last reset (captured ones, until moved to the
# replays that run them).
LAUNCHES = {DRIFT: 0, COMMIT: 0}

_LIB = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def rowdot(a, b):
    """Per-chain dot product: (C, dim) x (C, dim) -> (C,). An elementwise
    product summed along its rows rounds a row alike at any C; an einsum
    is a batched GEMM on the card, whose rounding of a row depends on the
    batch's size, so a chain would not compute the same energy in a shard
    of a mesh as in the whole batch."""
    return (a * b).sum(-1)


def _is_iterative_turning_b(p_leaf, v_leaf, rho_cum, ckpts):
    """U-turn checks of every sub-tree ending at this odd leaf, over the
    active checkpoint rows ``ckpts`` (C, R, 3, dim) = [p, v, rho]."""
    r, v_ck, rho_ck = ckpts.unbind(2)
    rho_c = rho_cum[:, None, :] - rho_ck + r - 0.5 * (r + p_leaf[:, None, :])
    t_left = (v_ck * rho_c).sum(-1) <= 0.0
    t_right = (rho_c * v_leaf[:, None, :]).sum(-1) <= 0.0
    return torch.any(t_left | t_right, dim=1)


# -- the plain versions ------------------------------------------------------


def leaf_drift_torch(cur, half, step, out=None):
    """The leapfrog step's drift from ``cur`` with the (C, 1) half and whole
    signed steps: q_n = q + step (v + half M^-1 g), (C, dim), into ``out``
    where given."""
    q, _, v, _, mg = cur.unbind(1)
    return torch.add(q, step * (v + half * mg), out=out)


def leaf_commit_torch(st, metric, half, step, q_n, q_next, logp_n, g_n, u_leaf, j: int, rows,
                      max_delta_energy: float, track: bool, counters=None) -> None:
    """The rest of leaf j after the value-and-grad (logp_n, g_n) at q_n,
    committed for the chains alive; a chain freezes at the leaf where it
    diverges or its sub-tree turns (so a tracked divergent step is written
    once per sub-tree). Then the next leaf's drift from the committed leaf
    state into ``q_next``, for every chain. With ``counters`` (L2's (3,)
    int32 on the card) the leaf is L2's: j = 2k + (j's parity) from the pair
    counter k, and an odd leaf advances k and sets the leaf loop's
    condition."""
    if counters is not None:
        j, *rows = device_rows(int(counters[K]), j % 2)
    q, p, v, g, mg = st.cur.unbind(1)  # the state q_n was drifted from
    p_half = p + half * g
    v_half = v + half * mg
    alive = st.alive
    mg_n = metric.velocity(g_n)
    p_n = p_half + half * g_n
    v_n = v_half + half * mg_n
    leaf = torch.stack([q_n, p_n, v_n, g_n, mg_n], dim=1)

    delta = -logp_n + 0.5 * rowdot(p_n, v_n) - st.h0
    bad = ~(delta <= max_delta_energy)  # NaN -> True
    w = torch.where(bad, -torch.inf, -delta)
    accept = torch.where(bad, 0.0, torch.exp(torch.clamp(-delta, max=0.0)))
    lsw = torch.logaddexp(st.s_lsw, w)
    take = alive & (u_leaf[j] < torch.exp(w - lsw))
    torch.where(take[:, None, None], leaf, st.s_prop, out=st.s_prop)
    torch.where(take, logp_n, st.s_logp_prop, out=st.s_logp_prop)

    alive3 = alive[:, None, None]
    torch.where(alive[:, None], st.s_rho + p_n, st.s_rho, out=st.s_rho)
    if j == 0:
        torch.where(alive3, leaf, st.first, out=st.first)
    if j % 2 == 0:
        row = rows[1]
        st.ckpts[:, row] = torch.where(
            alive3, torch.stack([p_n, v_n, st.s_rho], dim=1), st.ckpts[:, row]
        )
        stop = bad
    else:
        lo, hi = rows
        turned = _is_iterative_turning_b(p_n, v_n, st.s_rho, st.ckpts[:, lo : hi + 1])
        torch.where(alive, turned, st.s_turn, out=st.s_turn)
        stop = bad | turned

    if track:
        newly_bad = (alive & bad)[:, None]
        torch.where(newly_bad, q, st.s_div_edge, out=st.s_div_edge)
        torch.where(newly_bad, q_n, st.s_div_leaf, out=st.s_div_leaf)
    torch.where(alive3, leaf, st.cur, out=st.cur)
    torch.where(alive, lsw, st.s_lsw, out=st.s_lsw)
    st.s_sum_accept += torch.where(alive, accept, 0.0)
    st.s_n_leaves += alive
    st.s_div |= alive & bad
    alive &= ~stop
    leaf_drift_torch(st.cur, half, step, out=q_next)
    if counters is not None and j % 2:
        counters[K] += 1
        counters[CONDITION] = (counters[K] < u_leaf.shape[0] // 2) & alive.any()


def device_rows(k: int, parity: int):
    """L2's leaf index and checkpoint rows from the pair counter k and the
    leaf's parity, in the kernel's arithmetic (``__popc``, ``__ffs``):
    (j, lo, hi), which equal (j, *nuts._leaf_idx_to_ckpt_idxs(j))."""
    j = 2 * k + parity
    hi = bin(k).count("1")
    trailing_ones = ((~j) & (j + 1)).bit_length() - 1  # __ffs(~j) - 1
    return j, hi - trailing_ones + 1, hi


# -- the kernels -----------------------------------------------------------------


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(cuda_band.build(SOURCE)))
        p, i = ctypes.c_void_p, ctypes.c_int
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{DRIFT}_{suffix}")
            fn.argtypes, fn.restype = [p] * 4 + [i] * 2 + [p], i
            fn = getattr(lib, f"{COMMIT}_{suffix}")
            fn.argtypes, fn.restype = [p, p, ctypes.c_double, p], i
        _LIB = lib
    return _LIB


def _check(name, tensors, dtype, device) -> None:
    """Every tensor on ``device``, of ``dtype`` (bool where named so) and
    contiguous."""
    for what, t in tensors.items():
        want = (torch.bool if what in ("s_div", "s_turn", "alive")
                else torch.int32 if what == "counters" else dtype)
        if t.device != device or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous {want} tensor on {device}; "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def leaf_drift_cuda(cur, half, step, out=None):
    """L1: q_n = q + step * (v + half * mg) on the current stream, into
    ``out`` (C, dim) where given; cur (C, 5, dim), half and step (C,) or
    (C, 1), float32 or float64, on one CUDA device."""
    lib = _library()
    c, rows, dim = cur.shape
    half, step = half.reshape(c), step.reshape(c)
    q_n = torch.empty((c, dim), dtype=cur.dtype, device=cur.device) if out is None else out
    _check("leaf_drift_cuda", dict(cur=cur, half=half, step=step, q_n=q_n), cur.dtype,
           cur.device)
    if rows != 5 or cur.dtype not in (torch.float32, torch.float64) or q_n.shape != (c, dim):
        raise ValueError(f"leaf_drift_cuda: cur (C, 5, dim) float32 or float64 and q_n (C, dim); "
                         f"got {cur.dtype} {tuple(cur.shape)}, {tuple(q_n.shape)}")
    fn = getattr(lib, f"{DRIFT}_{'f32' if cur.dtype == torch.float32 else 'f64'}")
    stream = torch.cuda.current_stream(cur.device).cuda_stream
    _raise_on(fn(cur.data_ptr(), half.data_ptr(), step.data_ptr(), q_n.data_ptr(), c, dim,
                 stream), DRIFT)
    LAUNCHES[DRIFT] += 1
    return q_n


def _diagonal(inv_mass, c, dim):
    """A diagonal metric's inverse mass as the kernel reads it: (tensor,
    chain stride), shared (dim,) or expanded (C, dim) at stride 0, else per
    chain at stride dim."""
    if inv_mass.dim() == 1 or (inv_mass.dim() == 2 and inv_mass.stride(0) == 0):
        shared = inv_mass if inv_mass.dim() == 1 else inv_mass[0]
        if tuple(shared.shape) != (dim,):
            raise ValueError(f"leaf_commit_cuda: inv_mass {tuple(inv_mass.shape)} for dim {dim}")
        return shared.contiguous(), 0
    if tuple(inv_mass.shape) != (c, dim):
        raise ValueError(f"leaf_commit_cuda: inv_mass {tuple(inv_mass.shape)} for ({c}, {dim})")
    return inv_mass.contiguous(), dim


def leaf_commit_cuda(st, half, step, q_n, q_next, logp_n, g_n, mg_n, inv_mass, u_leaf,
                     parity: int, is_first: bool, max_delta_energy: float, track: bool,
                     handle=None) -> None:
    """L2 on the current stream: the commit of leaf j = 2k + ``parity`` (k
    the pair counter ``st.counters[0]`` on the card; ``is_first``: j == 0)
    into the buffers of ``st`` (see the module docstring) from q_n, logp_n,
    g_n and either mg_n (a dense metric's M^-1 g_n) or ``inv_mass`` (a
    diagonal metric's, whose product L2 computes); ``u_leaf`` (2^i, C) the
    doubling's uniforms; then the next leaf's drift at the (C,) or (C, 1)
    signed ``step`` into ``q_next`` (C, dim), another buffer than q_n. On an
    odd leaf L2 advances k and sets the leaf loop's condition, in
    ``st.counters[2]`` and in ``handle`` (a WHILE node's,
    ``ops/graph_if.WhileNodes.handle``) where given."""
    lib = _library()
    c, _, dim = st.cur.shape
    n_rows = st.ckpts.shape[1]
    if (mg_n is None) == (inv_mass is None):
        raise ValueError("leaf_commit_cuda: give exactly one of mg_n and inv_mass")
    stride = 0
    if inv_mass is not None:
        inv_mass, stride = _diagonal(inv_mass, c, dim)
    if parity not in (0, 1) or (is_first and parity):
        raise ValueError(f"leaf_commit_cuda: parity {parity}, is_first {is_first}")
    if q_next.data_ptr() == q_n.data_ptr():
        raise ValueError("leaf_commit_cuda: q_next must be another buffer than q_n")
    tensors = dict(
        cur=st.cur, q_n=q_n, q_next=q_next, logp_n=logp_n.contiguous(), g_n=g_n.contiguous(),
        mg_n=None if mg_n is None else mg_n.contiguous(), inv_mass=inv_mass,
        half=half.reshape(c), step=step.reshape(c), h0=st.h0, u_leaf=u_leaf, s_prop=st.s_prop,
        s_logp_prop=st.s_logp_prop, s_rho=st.s_rho, first=st.first, ckpts=st.ckpts,
        s_lsw=st.s_lsw, s_sum_accept=st.s_sum_accept, s_n_leaves=st.s_n_leaves, s_div=st.s_div,
        s_turn=st.s_turn, alive=st.alive,
        s_div_edge=st.s_div_edge if track else None, s_div_leaf=st.s_div_leaf if track else None,
        counters=st.counters)
    given = {k: t for k, t in tensors.items() if t is not None}
    _check("leaf_commit_cuda", given, st.cur.dtype, st.cur.device)
    n_leaves = u_leaf.shape[0] if u_leaf.dim() == 2 else -1
    shapes = {"q_n": (c, dim), "q_next": (c, dim), "g_n": (c, dim), "mg_n": (c, dim),
              "logp_n": (c,),
              "u_leaf": (n_leaves, c), "s_rho": (c, dim), "s_prop": (c, 5, dim),
              "first": (c, 5, dim), "counters": (3,)}
    for what, shape in shapes.items():
        if what in given and tuple(given[what].shape) != shape:
            raise ValueError(f"leaf_commit_cuda: {what} {tuple(given[what].shape)}, want {shape}")
    ptrs = (ctypes.c_void_p * len(COMMIT_POINTERS))(
        *(None if tensors[k] is None else tensors[k].data_ptr() for k in COMMIT_POINTERS))
    ints = (ctypes.c_longlong * N_COMMIT_INTS)(
        c, dim, n_rows, stride, n_leaves, parity, int(is_first), handle is not None,
        ctypes.c_longlong(handle or 0).value, len(COMMIT_POINTERS), N_COMMIT_INTS)
    fn = getattr(lib, f"{COMMIT}_{'f32' if st.cur.dtype == torch.float32 else 'f64'}")
    stream = torch.cuda.current_stream(st.cur.device).cuda_stream
    _raise_on(fn(ptrs, ints, float(max_delta_energy), stream), COMMIT)
    LAUNCHES[COMMIT] += 1


# -- the dispatch --------------------------------------------------------------------


def _on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernels), False for a CPU one (the plain
    versions)."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"NUTS leaf: unsupported device {t.device}")
    return t.device.type == "cuda"


def leaf_drift(cur, half, step, out=None):
    """q_n (into ``out`` where given): L1 on the card, the plain version on
    the CPU."""
    if _on_card(cur):
        return leaf_drift_cuda(cur, half, step, out)
    return leaf_drift_torch(cur, half, step, out)


def leaf_commit(st, metric, half, step, q_n, q_next, logp_n, g_n, u_leaf, j: int, rows,
                max_delta_energy: float, track: bool, handle=None) -> None:
    """Leaf j's commit and the next leaf's drift into ``q_next``: L2 on the
    card (after the metric's product where it is not diagonal; j's parity
    and j == 0 are what it takes of j, the rest comes from ``st.counters``;
    ``handle`` the doubling's WHILE node's), the plain version on the CPU
    (with ``st.counters`` where the state has them)."""
    if _on_card(q_n):
        inv_mass = metric.diagonal()
        mg_n = metric.velocity(g_n) if inv_mass is None else None
        leaf_commit_cuda(st, half, step, q_n, q_next, logp_n, g_n, mg_n, inv_mass, u_leaf,
                         j % 2, j == 0, max_delta_energy, track, handle)
        return
    leaf_commit_torch(st, metric, half, step, q_n, q_next, logp_n, g_n, u_leaf, j, rows,
                      max_delta_energy, track, getattr(st, "counters", None))


# -- the bytes bound -----------------------------------------------------------------


def drift_bytes(c: int, dim: int, itemsize: int) -> int:
    """Bytes L1 must move: q, v and mg of cur read, q_n written, the two
    (C,) steps read."""
    return itemsize * (4 * c * dim + 2 * c)


def commit_bytes(c: int, dim: int, itemsize: int, j: int, rows, n_alive: int, n_take: int,
                 n_bad: int, metric: str, track: bool) -> int:
    """Bytes L2 must move for one launch, counted from its data: every
    chain's alive flag, its half and whole step read and its next leaf's q
    written; per alive chain p, v, g and mg of cur, q_n, g_n, mg_n
    (``metric`` "dense") or its inverse mass ("diag"; once for "shared"),
    rho and six more scalars read, and cur (five rows), rho, three scalars
    and three flags written; per chain not alive q, v and mg of cur read;
    per take the proposal's five rows; at j = 0 the first leaf's five rows;
    on an even leaf one checkpoint row written (three rows), on an odd one
    rows lo..hi read; with ``track`` per divergent alive chain its old q
    read and the edge and leaf written; the pair counter read, and on an odd
    leaf the arrivals, the counter and the condition written (int32)."""
    lo, hi = rows
    per_alive_rows = 4 + 3 + (metric != "shared") + 5 + 1
    per_alive_rows += 5 if j == 0 else 0
    per_alive_rows += 3 if j % 2 == 0 else 3 * (hi - lo + 1)
    rows_moved = (n_alive * per_alive_rows + 3 * (c - n_alive) + c + 5 * n_take
                  + (3 * n_bad if track else 0))
    if metric == "shared" and n_alive:
        rows_moved += 1  # the shared diagonal, read once
    # per chain its two steps; per alive chain six more read and three
    # written; logp_n where taken
    scalars = 2 * c + n_alive * 9 + n_take
    counters = 16 if j % 2 else 4  # int32: k read; on an odd leaf three written
    return itemsize * (rows_moved * dim + scalars) + c + 3 * n_alive + counters  # + the flags
