"""The NUTS doubling of the batched tree: three hand-written CUDA kernels
(csrc/nuts_leaf.cu), their plain versions and the dispatch between them.

Counterpart of the JAX package's fused bodies in inference/nuts_batched.py:
the outer ``lax.while_loop``'s body (:399-494) with ``_is_turning_b``, the
sub-tree init of ``_build_subtree_b`` (:304-322), and its leaf loop's body
(:225-302, with ``_leapfrog_b``, ``_rowdot`` (``rowdot`` here),
``_is_iterative_turning_b`` and ``_row_update``), which XLA compiles into a
few fused loops. A doubling of depth i of ``inference/nuts_batched.LockstepTree``
is, after its draws u (2, C) and u_leaf (2^i, C),

    half, step = doubling_open(st, u, 2^i, track)            # D1
    for each leaf j:
        logp_n, g_n = vg(st.q[j % 2])
        leaf_commit(st, metric, half, step, st.q[j % 2], st.q[1 - j % 2], logp_n, g_n,
                    u_leaf, j, (lo, hi), max_delta_energy, track, handle)   # L2
    doubling_merge(st, u, 2^i, i + 1, track)                  # D2

over the tree's buffers ``st``: the trajectory (``left``, ``right``,
``prop`` (C, 5, dim) = [q, p, v, grad, M^-1 grad], ``rho``, the (C,)
``logp_prop``, ``log_sum_w``, ``sum_accept``, ``num_leaves``, ``diverging``,
``done``, ``depth``), the sub-tree (``cur``, ``s_prop``, ``s_rho``, ``ckpts`` (C, R, 3, dim), the (C,) sums and flags ``s_lsw``,
``s_logp_prop``, ``s_sum_accept``, ``s_n_leaves``, ``s_div``, ``s_turn``,
``alive``), ``eps``, ``h0``, the two positions ``q`` (2, C, dim), with
``track`` ``s_div_edge``, ``s_div_leaf``, ``div_edge``, ``div_leaf``, the
``readout`` (all chains done, leaves run) and on the card ``counters`` and
``half``, ``step``; updated in place. ``u_leaf`` are the doubling's uniforms,
j the leaf's index and (lo, hi) its checkpoint rows
(``nuts._leaf_idx_to_ckpt_idxs``; hi is the row an even leaf writes).

D1, the opening, takes the direction from u[0] and writes the signed step and
half step, the edge in that direction into ``cur`` and ``s_prop``, the
sub-tree's reset sums and flags, ``alive = ~done``, the pair counter's zeros,
and leaf 0's position into ``st.q[0]``: the drift ``leaf_drift_torch`` of the
edge. It leaves the checkpoint rows as they were: no kernel reads one
before writing it in the same doubling (csrc/nuts_leaf.cu). The
step is a constant of the doubling, so the commit of leaf j also writes the
next leaf's position, ``q_next`` = the drift of the leaf state it has
committed, for every chain (a chain that is not alive keeps its state, and
its q_next is the drift of that state). The tree alternates two q buffers by
the leaf's parity (``st.q[j % 2]`` is q_n, ``st.q[1 - j % 2]`` q_next), so a
commit never writes the q_n it reads. D2, the merge, folds the sub-tree into
the trajectory by u[1] and writes the readout.

On the card the leaf index is on the device, as the JAX package's leaf
counter is a scalar of its loop: ``st.counters`` = [k, blocks arrived,
condition] (int32), k the doubling's pair counter, zeroed by D1. L2
takes the leaf's parity (a constant of a graph's capture), derives
j = 2k + parity, its rows and its uniform u_leaf[j] (``device_rows`` is the
same arithmetic in Python), and on an odd leaf advances k and sets the leaf
loop's condition ``k < 2^i / 2 and any(alive)``: into ``counters[2]`` and,
given the handle of a WHILE node (``ops/graph_if.py``), into the handle, so
that the node runs the doubling's next leaf pair or ends. D2 reads the leaves
run off k (2k; 1 at depth 0). Given ``counters`` the plain versions do the
same: the commit takes j from them and advances and sets them alike, and the
merge writes the readout from k; without (the CPU tree, which reads no
readout) the commit keeps the host's j and the merge writes no readout.

On a CUDA tensor the dispatch launches the kernels on the current stream
(so that a CUDA graph captures them, inside a WHILE node's body too): D1
``nuts_doubling_open``, L2 ``nuts_leaf_commit`` after the value-and-grad and,
for a dense or per-rung metric, its product ``metric.velocity(g_n)`` (a dense
metric's: the kernel of ``ops/minv_mv.py``; a per-rung one's an einsum; a
diagonal metric's product is L2's), and D2 ``nuts_doubling_merge``. A failed
build or launch raises: there is no fallback. On a CPU tensor it runs the
plain versions, ``doubling_open_torch``, ``leaf_commit_torch`` and
``doubling_merge_torch``, which issue the tree's operations of the doubling
in their order, and which the card's kernels are held against
(``chip_smoke.py``'s [leaf]).

While the tracer (``utils/trace.py``) is on, each kernel is launched (and
captured) with the address of its stamp buffer, its last pointer argument:
D1 stamps the stage ``open``, L2 ``commit`` (closing the stage its
``trace_prev`` names), D2 ``merge`` on entry and ``between_graphs`` on
exit; off, the address is null. The stamps change no bit the kernels
write.

``LAUNCHES`` counts each kernel's launches: a wrapper adds one per launch,
and the tree moves the launches its CUDA graphs captured to each replay
(``LockstepTree._capture``, ``_replay``): one D1 and one D2 per doubling, one
L2 per leaf run.

The source is compiled at first use with nvcc for sm_90a into
``<package>/build/`` (``ops/cuda_band.build``) and bound with ctypes.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..utils import trace
from . import cuda_band

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "nuts_leaf.cu"
OPEN, COMMIT, MERGE = "nuts_doubling_open", "nuts_leaf_commit", "nuts_doubling_merge"
# L2's pointer arguments, in the order of the kernel's CommitArgs
COMMIT_POINTERS = ("cur", "q_n", "q_next", "logp_n", "g_n", "mg_n", "inv_mass", "half", "step",
                   "h0", "u_leaf", "s_prop", "s_logp_prop", "s_rho", "ckpts", "s_lsw",
                   "s_sum_accept", "s_n_leaves", "s_div", "s_turn", "alive", "s_div_edge",
                   "s_div_leaf", "counters", "trace")
# L2's integer arguments, in the order of the kernel's CommitArgs, then the
# two counts the kernel checks against its own
COMMIT_INTS = ("n_chains", "dim", "n_rows", "inv_mass_stride", "n_leaves", "parity",
               "has_handle", "handle", "trace_prev", "n_pointers", "n_ints")
N_COMMIT_INTS = len(COMMIT_INTS)
# D1's and D2's pointer arguments, in the order of the kernel's OpenArgs and
# MergeArgs, and their integer arguments, then the two counts each kernel
# checks against its own
OPEN_POINTERS = ("u", "eps", "left", "right", "done", "cur", "s_prop", "q0", "half", "step",
                 "s_rho", "s_logp_prop", "s_lsw", "s_sum_accept", "s_n_leaves", "s_div", "s_turn",
                 "alive", "s_div_edge", "s_div_leaf", "counters", "trace")
OPEN_INTS = ("n_chains", "dim", "u_stride", "n_pointers", "n_ints")
MERGE_POINTERS = ("u", "cur", "s_prop", "s_rho", "s_lsw", "s_logp_prop", "s_sum_accept",
                  "s_n_leaves", "s_div", "s_turn", "s_div_edge", "s_div_leaf", "left", "right",
                  "prop", "rho", "logp_prop", "log_sum_w", "sum_accept", "num_leaves",
                  "diverging", "done", "depth", "div_edge", "div_leaf", "counters", "readout",
                  "trace")
MERGE_INTS = ("n_chains", "dim", "u_stride", "n_leaves", "new_depth", "n_pointers", "n_ints")
# st.counters: the pair counter, the blocks arrived, the leaf loop's condition
K, ARRIVED, CONDITION = range(3)

# Kernel launches since the last reset (captured ones, until moved to the
# replays that run them).
LAUNCHES = {OPEN: 0, COMMIT: 0, MERGE: 0}

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


def _is_turning_b(p_left, v_left, p_right, v_right, rho):
    """(C,) generalized U-turn check with the boundary-momentum correction;
    v_* are the carried M^-1 p_*."""
    rho_c = rho - 0.5 * (p_left + p_right)
    return (rowdot(v_left, rho_c) <= 0.0) | (rowdot(v_right, rho_c) <= 0.0)


def _is_iterative_turning_b(p_leaf, v_leaf, rho_cum, ckpts):
    """U-turn checks of every sub-tree ending at this odd leaf, over the
    active checkpoint rows ``ckpts`` (C, R, 3, dim) = [p, v, rho]."""
    r, v_ck, rho_ck = ckpts.unbind(2)
    rho_c = rho_cum[:, None, :] - rho_ck + r - 0.5 * (r + p_leaf[:, None, :])
    t_left = (v_ck * rho_c).sum(-1) <= 0.0
    t_right = (rho_c * v_leaf[:, None, :]).sum(-1) <= 0.0
    return torch.any(t_left | t_right, dim=1)


# -- the plain versions ------------------------------------------------------


def doubling_open_torch(st, u, n_leaves: int, track: bool):
    """The doubling's opening from its uniforms ``u`` (2, C) (u[0] < 0.5:
    to the right): the edge in that direction into ``cur`` and ``s_prop``,
    the sub-tree's sums and flags reset, ``alive = ~done``, the pair counter
    zeroed where the state has one, the tracked divergent step zeroed, and
    leaf 0's position, the drift of the edge, into ``st.q[0]``. Returns
    (half, step), each (C, 1)."""
    go_right = u[0] < 0.5
    eps_signed = torch.where(go_right, 1.0, -1.0).to(st.eps.dtype) * st.eps
    torch.where(go_right[:, None, None], st.right, st.left, out=st.cur)
    st.s_prop.copy_(st.cur)
    for buf in (st.s_rho, st.s_logp_prop, st.s_sum_accept, st.s_n_leaves, st.s_div, st.s_turn):
        buf.zero_()
    st.s_lsw.fill_(-torch.inf)
    torch.logical_not(st.done, out=st.alive)
    if getattr(st, "counters", None) is not None:
        st.counters.zero_()
    if track:
        st.s_div_edge.zero_()
        st.s_div_leaf.zero_()
    half, step = (0.5 * eps_signed)[:, None], eps_signed[:, None]
    leaf_drift_torch(st.cur, half, step, out=st.q[0])
    return half, step


def doubling_merge_torch(st, u, n_leaves: int, depth: int, track: bool) -> None:
    """The sub-tree of the doubling opened by ``u`` merged into the
    trajectory for the chains not done before it: the proposal taken by
    u[1] against the weights' ratio where the sub-tree neither diverged nor
    turned (valid), the sub-tree's last leaf as the new edge on the side
    that moved, rho, log_sum_w, the sums, the tracked divergent step, the
    flags (done also where the merged trajectory turns), ``depth`` (i + 1);
    then, where the state has the pair counter, the readout (all chains
    done, the leaves run: 2 k, 1 at n_leaves = 1), as D2 writes it."""
    upd = ~st.done
    gr3 = (u[0] < 0.5)[:, None, None]
    valid = upd & ~(st.s_div | st.s_turn)
    take_new = valid & (
        u[1] < torch.exp(torch.clamp(st.s_lsw - st.log_sum_w, max=0.0))
    )
    torch.where(take_new[:, None, None], st.s_prop, st.prop, out=st.prop)
    torch.where(take_new, st.s_logp_prop, st.logp_prop, out=st.logp_prop)
    new_left = torch.where(gr3, st.left, st.cur)
    new_right = torch.where(gr3, st.cur, st.right)
    new_rho = st.rho + st.s_rho
    turning_combined = _is_turning_b(
        new_left[:, 1], new_left[:, 2], new_right[:, 1], new_right[:, 2], new_rho
    )
    valid3 = valid[:, None, None]
    torch.where(valid3, new_left, st.left, out=st.left)
    torch.where(valid3, new_right, st.right, out=st.right)
    torch.where(valid[:, None], new_rho, st.rho, out=st.rho)
    torch.where(valid, torch.logaddexp(st.log_sum_w, st.s_lsw), st.log_sum_w,
                out=st.log_sum_w)
    st.sum_accept += torch.where(upd, st.s_sum_accept, 0.0)
    st.num_leaves += torch.where(upd, st.s_n_leaves, 0.0)
    if track:
        # one divergent sub-tree at most per transition: done is set
        hit = (upd & st.s_div)[:, None]
        torch.where(hit, st.s_div_edge, st.div_edge, out=st.div_edge)
        torch.where(hit, st.s_div_leaf, st.div_leaf, out=st.div_leaf)
    st.diverging |= upd & st.s_div
    st.done |= upd & (st.s_div | st.s_turn | turning_combined)
    st.depth.masked_fill_(upd, depth)
    counters = getattr(st, "counters", None)
    if counters is not None:
        st.readout[0] = st.done.all()
        st.readout[1] = 1 if n_leaves == 1 else 2 * counters[K]


def leaf_drift_torch(cur, half, step, out=None):
    """The leapfrog step's drift from ``cur`` with the (C, 1) half and whole
    signed steps: q_n = q + step (v + half M^-1 g), (C, dim), into ``out``
    where given. D1 writes leaf 0's position with its arithmetic, L2 every
    next leaf's."""
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
        p = ctypes.c_void_p
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{COMMIT}_{suffix}")
            fn.argtypes, fn.restype = [p, p, ctypes.c_double, p], ctypes.c_int
            for name in (OPEN, MERGE):
                fn = getattr(lib, f"{name}_{suffix}")
                fn.argtypes, fn.restype = [p, p, p], ctypes.c_int
        _LIB = lib
    return _LIB


_BOOLS = ("s_div", "s_turn", "alive", "done", "diverging")
_INTS = {"counters": torch.int32, "depth": torch.int32, "readout": torch.int64}


def _check(name, tensors, dtype, device) -> None:
    """Every tensor on ``device``, of ``dtype`` (bool or an integer type
    where named so) and contiguous."""
    for what, t in tensors.items():
        want = torch.bool if what in _BOOLS else _INTS.get(what, dtype)
        if t.device != device or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous {want} tensor on {device}; "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _shapes(name, tensors, shapes) -> None:
    for what, shape in shapes.items():
        if tensors.get(what) is not None and tuple(tensors[what].shape) != shape:
            raise ValueError(f"{name}: {what} {tuple(tensors[what].shape)}, want {shape}")


def _uniforms(name, u, c, dtype, device) -> int:
    """The row stride of the doubling's (2, C) uniforms, whose columns may be
    a mesh's block of a wider draw."""
    if (tuple(u.shape) != (2, c) or u.dtype != dtype or u.device != device
            or (c > 1 and u.stride(1) != 1)):
        raise ValueError(f"{name}: u must be a (2, {c}) {dtype} tensor on {device} with "
                         f"unit column stride; got {u.dtype} {tuple(u.shape)} strides "
                         f"{u.stride()} on {u.device}")
    return u.stride(0)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _address(t):
    """A pointer argument: a tensor's data, an address as it is, or null."""
    return t if t is None or isinstance(t, int) else t.data_ptr()


def _stamp(stamp, device, stage):
    """(the stamp buffer's address, the stage its stamp closes) a launch
    takes: ``stamp`` where given (an address, 0 for none; it closes
    ``metric``), else the tracer's (null while it is off)."""
    if stamp is None:
        return trace.stamp(device, stage)
    return stamp or None, trace.METRIC


def _launch(name, lib, ptr_names, tensors, ints, dtype, stream, *extra) -> None:
    """One launch of kernel ``name`` of ``lib`` on ``stream``: the tensors of
    ``ptr_names`` (None as a null pointer; the stamp buffer an address), the
    integers ``ints`` and the two counts the kernel checks, then ``extra``
    arguments; counted in LAUNCHES."""
    ptrs = (ctypes.c_void_p * len(ptr_names))(*(_address(tensors[k]) for k in ptr_names))
    ints = (ctypes.c_longlong * (len(ints) + 2))(*ints, len(ptr_names), len(ints) + 2)
    suffix = "f32" if dtype == torch.float32 else "f64"
    _raise_on(getattr(lib, f"{name}_{suffix}")(ptrs, ints, *extra, stream), name)
    LAUNCHES[name] += 1


def doubling_open_cuda(st, u, n_leaves: int, track: bool, stamp=None):
    """D1 on the current stream: the opening of a doubling of ``n_leaves``
    leaves from its uniforms ``u`` (2, C) into the buffers of ``st`` (see
    the module docstring), leaf 0's position into ``st.q[0]``, the signed
    step and half step into ``st.step`` and ``st.half``; ``stamp`` as
    ``_stamp`` takes it. Returns (half, step), views (C, 1) of those."""
    lib = _library()
    c, rows, dim = st.cur.shape
    dtype, device = st.cur.dtype, st.cur.device
    if rows != 5 or dtype not in (torch.float32, torch.float64) or n_leaves < 1:
        raise ValueError(f"doubling_open_cuda: cur (C, 5, dim) float32 or float64, n_leaves >= 1; "
                         f"got {dtype} {tuple(st.cur.shape)}, {n_leaves}")
    u_stride = _uniforms("doubling_open_cuda", u, c, dtype, device)
    tensors = dict(
        u=u, eps=st.eps, left=st.left, right=st.right, done=st.done, cur=st.cur, s_prop=st.s_prop,
        q0=st.q[0], half=st.half, step=st.step, s_rho=st.s_rho, s_logp_prop=st.s_logp_prop,
        s_lsw=st.s_lsw, s_sum_accept=st.s_sum_accept, s_n_leaves=st.s_n_leaves, s_div=st.s_div,
        s_turn=st.s_turn, alive=st.alive, s_div_edge=st.s_div_edge if track else None,
        s_div_leaf=st.s_div_leaf if track else None, counters=st.counters)
    given = {k: t for k, t in tensors.items() if t is not None and k != "u"}
    _check("doubling_open_cuda", given, dtype, device)
    tensors["trace"], _ = _stamp(stamp, device, trace.OPEN)
    row, scalar = (c, dim), (c,)
    _shapes("doubling_open_cuda", given, dict(
        eps=scalar, left=(c, 5, dim), right=(c, 5, dim), done=scalar, s_prop=(c, 5, dim), q0=row,
        half=scalar, step=scalar, s_rho=row, s_logp_prop=scalar, s_lsw=scalar,
        s_sum_accept=scalar, s_n_leaves=scalar, s_div=scalar, s_turn=scalar, alive=scalar,
        s_div_edge=row, s_div_leaf=row, counters=(3,)))
    _launch(OPEN, lib, OPEN_POINTERS, tensors, (c, dim, u_stride), dtype,
            torch.cuda.current_stream(device).cuda_stream)
    return st.half.view(c, 1), st.step.view(c, 1)


def doubling_merge_cuda(st, u, n_leaves: int, depth: int, track: bool, stamp=None) -> None:
    """D2 on the current stream: the sub-tree of the doubling of
    ``n_leaves`` leaves opened by ``u`` (2, C) merged into the trajectory's
    buffers of ``st``, ``depth`` (i + 1) written where the chain was not done,
    then ``st.readout`` = (all chains done, the leaves run: 2 k of the pair
    counter ``st.counters``, 1 at n_leaves = 1); ``stamp`` as ``_stamp``
    takes it."""
    lib = _library()
    c, rows, dim = st.cur.shape
    dtype, device = st.cur.dtype, st.cur.device
    if rows != 5 or dtype not in (torch.float32, torch.float64) or n_leaves < 1:
        raise ValueError(f"doubling_merge_cuda: cur (C, 5, dim) float32 or float64, "
                         f"n_leaves >= 1; got {dtype} {tuple(st.cur.shape)}, {n_leaves}")
    u_stride = _uniforms("doubling_merge_cuda", u, c, dtype, device)
    tracked = dict(s_div_edge=st.s_div_edge, s_div_leaf=st.s_div_leaf, div_edge=st.div_edge,
                   div_leaf=st.div_leaf) if track else dict.fromkeys(
                       ("s_div_edge", "s_div_leaf", "div_edge", "div_leaf"))
    tensors = dict(
        u=u, cur=st.cur, s_prop=st.s_prop, s_rho=st.s_rho, s_lsw=st.s_lsw,
        s_logp_prop=st.s_logp_prop, s_sum_accept=st.s_sum_accept, s_n_leaves=st.s_n_leaves,
        s_div=st.s_div, s_turn=st.s_turn, left=st.left, right=st.right, prop=st.prop,
        rho=st.rho, logp_prop=st.logp_prop, log_sum_w=st.log_sum_w, sum_accept=st.sum_accept,
        num_leaves=st.num_leaves, diverging=st.diverging, done=st.done, depth=st.depth,
        counters=st.counters, readout=st.readout, **tracked)
    given = {k: t for k, t in tensors.items() if t is not None and k != "u"}
    _check("doubling_merge_cuda", given, dtype, device)
    row, scalar, state = (c, dim), (c,), (c, 5, dim)
    _shapes("doubling_merge_cuda", given, dict(
        s_prop=state, s_rho=row, s_lsw=scalar, s_logp_prop=scalar, s_sum_accept=scalar,
        s_n_leaves=scalar, s_div=scalar, s_turn=scalar, s_div_edge=row, s_div_leaf=row,
        left=state, right=state, prop=state, rho=row, logp_prop=scalar, log_sum_w=scalar,
        sum_accept=scalar, num_leaves=scalar, diverging=scalar, done=scalar, depth=scalar,
        div_edge=row, div_leaf=row, counters=(3,), readout=(2,)))
    tensors["trace"], _ = _stamp(stamp, device, trace.MERGE)
    _launch(MERGE, lib, MERGE_POINTERS, tensors, (c, dim, u_stride, n_leaves, depth), dtype,
            torch.cuda.current_stream(device).cuda_stream)


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
                     parity: int, max_delta_energy: float, track: bool,
                     handle=None, stamp=None) -> None:
    """L2 on the current stream: the commit of leaf j = 2k + ``parity`` (k
    the pair counter ``st.counters[0]`` on the card) into the buffers of ``st`` (see the module docstring) from q_n, logp_n,
    g_n and either mg_n (a dense metric's M^-1 g_n) or ``inv_mass`` (a
    diagonal metric's, whose product L2 computes); ``u_leaf`` (2^i, C) the
    doubling's uniforms; then the next leaf's drift at the (C,) or (C, 1)
    signed ``step`` into ``q_next`` (C, dim), another buffer than q_n. On an
    odd leaf L2 advances k and sets the leaf loop's condition, in
    ``st.counters[2]`` and in ``handle`` (a WHILE node's,
    ``ops/graph_if.WhileNodes.handle``) where given; ``stamp`` as ``_stamp``
    takes it."""
    lib = _library()
    c, _, dim = st.cur.shape
    n_rows = st.ckpts.shape[1]
    if (mg_n is None) == (inv_mass is None):
        raise ValueError("leaf_commit_cuda: give exactly one of mg_n and inv_mass")
    stride = 0
    if inv_mass is not None:
        inv_mass, stride = _diagonal(inv_mass, c, dim)
    if parity not in (0, 1):
        raise ValueError(f"leaf_commit_cuda: parity {parity}")
    if q_next.data_ptr() == q_n.data_ptr():
        raise ValueError("leaf_commit_cuda: q_next must be another buffer than q_n")
    tensors = dict(
        cur=st.cur, q_n=q_n, q_next=q_next, logp_n=logp_n.contiguous(), g_n=g_n.contiguous(),
        mg_n=None if mg_n is None else mg_n.contiguous(), inv_mass=inv_mass,
        half=half.reshape(c), step=step.reshape(c), h0=st.h0, u_leaf=u_leaf, s_prop=st.s_prop,
        s_logp_prop=st.s_logp_prop, s_rho=st.s_rho, ckpts=st.ckpts,
        s_lsw=st.s_lsw, s_sum_accept=st.s_sum_accept, s_n_leaves=st.s_n_leaves, s_div=st.s_div,
        s_turn=st.s_turn, alive=st.alive,
        s_div_edge=st.s_div_edge if track else None, s_div_leaf=st.s_div_leaf if track else None,
        counters=st.counters)
    given = {k: t for k, t in tensors.items() if t is not None}
    _check("leaf_commit_cuda", given, st.cur.dtype, st.cur.device)
    n_leaves = u_leaf.shape[0] if u_leaf.dim() == 2 else -1
    _shapes("leaf_commit_cuda", given, {
        "q_n": (c, dim), "q_next": (c, dim), "g_n": (c, dim), "mg_n": (c, dim), "logp_n": (c,),
        "u_leaf": (n_leaves, c), "s_rho": (c, dim), "s_prop": (c, 5, dim), "counters": (3,)})
    tensors["trace"], prev = _stamp(stamp, st.cur.device, trace.COMMIT)
    _launch(COMMIT, lib, COMMIT_POINTERS, tensors, (
        c, dim, n_rows, stride, n_leaves, parity, handle is not None,
        ctypes.c_longlong(handle or 0).value, prev), st.cur.dtype,
        torch.cuda.current_stream(st.cur.device).cuda_stream, float(max_delta_energy))


# -- the dispatch --------------------------------------------------------------------


def _on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernels), False for a CPU one (the plain
    versions)."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"NUTS leaf: unsupported device {t.device}")
    return t.device.type == "cuda"


def doubling_open(st, u, n_leaves: int, track: bool):
    """The doubling's opening (half, step): D1 on the card, the plain version
    on the CPU."""
    if _on_card(st.cur):
        return doubling_open_cuda(st, u, n_leaves, track)
    return doubling_open_torch(st, u, n_leaves, track)


def leaf_commit(st, metric, half, step, q_n, q_next, logp_n, g_n, u_leaf, j: int, rows,
                max_delta_energy: float, track: bool, handle=None) -> None:
    """Leaf j's commit and the next leaf's drift into ``q_next``: L2 on the
    card (after the metric's product where it is not diagonal; j's parity
    is what it takes of j, the rest comes from ``st.counters``;
    ``handle`` the doubling's WHILE node's), the plain version on the CPU
    (with ``st.counters`` where the state has them)."""
    if _on_card(q_n):
        inv_mass = metric.diagonal()
        mg_n = None
        if inv_mass is None:
            with trace.stage(trace.METRIC):
                mg_n = metric.velocity(g_n)
        leaf_commit_cuda(st, half, step, q_n, q_next, logp_n, g_n, mg_n, inv_mass, u_leaf,
                         j % 2, max_delta_energy, track, handle)
        return
    leaf_commit_torch(st, metric, half, step, q_n, q_next, logp_n, g_n, u_leaf, j, rows,
                      max_delta_energy, track, getattr(st, "counters", None))


def doubling_merge(st, u, n_leaves: int, depth: int, track: bool) -> None:
    """The doubling's merge and readout: D2 on the card, the plain version on
    the CPU."""
    if _on_card(st.cur):
        doubling_merge_cuda(st, u, n_leaves, depth, track)
        return
    doubling_merge_torch(st, u, n_leaves, depth, track)


# -- the bytes bound -----------------------------------------------------------------


def open_bytes(c: int, dim: int, itemsize: int, track: bool) -> int:
    """Bytes D1 must move: per chain the edge's five rows, its direction's
    uniform, step size and done flag read; cur and the sub-tree's proposal
    (five rows each), leaf 0's q and rho (with ``track`` the divergent
    step's two rows too), six scalars (half, step, four sums) and three
    flags written; the (3,) int32 pair counter written."""
    rows = 5 + 5 + 5 + 1 + 1 + (2 if track else 0)
    return itemsize * (c * rows * dim + 8 * c) + 4 * c + 12


def merge_bytes(c: int, dim: int, itemsize: int, n_upd: int, n_valid: int, n_take: int,
                n_div: int, track: bool) -> int:
    """Bytes D2 must move for one launch, counted from its data: every
    chain's done flag read; per chain not done before the doubling (n_upd)
    its two sub-tree flags, two sub-tree sums read, two sums read and
    written, its depth (int32) and done flag written; per valid chain (the
    sub-tree neither diverged nor turned) its two uniforms, two weights
    read and one written, the sub-tree's last leaf (five rows), the kept
    side's p and v, rho and the sub-tree's rho read, the moved side (five
    rows) and rho written; per take the proposal's five rows and its
    log-density read and written; per divergent sub-tree its diverging
    flag written and with ``track`` the divergent step's two rows read and
    written; the pair counter read and the (2,) int64 readout written."""
    rows = 15 * n_valid + 10 * n_take + (4 * n_div if track else 0)
    scalars = 6 * n_upd + 5 * n_valid + 2 * n_take
    return itemsize * (rows * dim + scalars) + c + 7 * n_upd + n_div + 4 + 16


def commit_bytes(c: int, dim: int, itemsize: int, j: int, rows, n_alive: int, n_take: int,
                 n_bad: int, metric: str, track: bool) -> int:
    """Bytes L2 must move for one launch, counted from its data: every
    chain's alive flag, its half and whole step read and its next leaf's q
    written; per alive chain p, v, g and mg of cur, q_n, g_n, mg_n
    (``metric`` "dense") or its inverse mass ("diag"; once for "shared"),
    rho and six more scalars read, and cur (five rows), rho, three scalars
    and three flags written; per chain not alive q, v and mg of cur read;
    per take the proposal's five rows; on an even leaf one checkpoint row written (three rows), on an odd one
    rows lo..hi read; with ``track`` per divergent alive chain its old q
    read and the edge and leaf written; the pair counter read, and on an odd
    leaf the arrivals, the counter and the condition written (int32)."""
    lo, hi = rows
    per_alive_rows = 4 + 3 + (metric != "shared") + 5 + 1
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
