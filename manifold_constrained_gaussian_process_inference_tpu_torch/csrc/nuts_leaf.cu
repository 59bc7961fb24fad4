// The NUTS doubling of the batched tree (sm_90a): three kernels that take the
// place of the JAX package's fused bodies in inference/nuts_batched.py, the
// outer lax.while_loop's body (:399-494) around _build_subtree_b's sub-tree
// init (:304-322) and its leaf loop's body (:225-302), which XLA compiles into
// a few fused loops over the (C, dim) state. The port's plain versions are
// ops/leaf.py's doubling_open_torch, leaf_commit_torch and doubling_merge_torch
// (about 20, 60 and 25 small kernels on the card); the tree is
// inference/nuts_batched.py's LockstepTree. A doubling on the card is D1, then
// per leaf the value-and-grad (and a dense metric's product) and L2, then D2.
//
//   D1 nuts_doubling_open   the doubling's opening, from the direction's
//                           uniform u[0] the graph has drawn: the signed step
//                           and half step, the edge in that direction copied
//                           into the leaf state cur (C, 5, dim) = [q, p, v,
//                           grad, M^-1 grad] and the sub-tree's proposal, the
//                           sub-tree's sums and flags reset, alive = !done,
//                           the pair counter zeroed (the tracked divergent
//                           step zeroed too), and leaf 0's position
//                           q0 = q + step * (v + half * mg) (drift_of);
//   L2 nuts_leaf_commit     after the value-and-grad at q_n (and, for a dense
//                           metric, its product M^-1 g_n): p_n and v_n, the
//                           energy error, divergence (NaN counts as divergent),
//                           the multinomial weight, its log-sum-exp and the
//                           take against the leaf's uniform, the masked commits
//                           of the proposal, rho, the
//                           checkpoint row (even leaves) or the U-turn sweep
//                           over the checkpoint rows lo..hi (odd leaves), the
//                           divergent step when tracked, the leaf state, the
//                           sub-tree's sums and flags, and alive &= ~stop. For
//                           a diagonal metric it also computes mg_n = inv_mass
//                           * g_n, with inv_mass shared (chain stride 0) or per
//                           chain. On an odd leaf it also advances the
//                           doubling's pair counter and sets the leaf loop's
//                           condition (below). Last, it writes the next leaf's
//                           q_next, drifted from the committed leaf state, for
//                           every chain (below);
//   D2 nuts_doubling_merge  the sub-tree merged into the trajectory: valid and
//                           the take against u[1], the proposal's commit, the
//                           new edge on the side that moved, rho, the combined
//                           U-turn check, log_sum_w, the sums, the tracked
//                           divergent step, diverging, done, depth, and the
//                           readout the host reads after a doubling (all
//                           chains done, the leaves run).
//
// The drift. The step is a constant of the doubling, so the drift of leaf
// j + 1 needs nothing that leaf j's commit does not hold: L2 writes q_next
// from the leaf state it commits (q_n, v_n, mg_n of a chain alive; cur's q, v,
// mg of a chain that is not, whose state stays) with the drift's rounded
// operations in the plain drift's order (drift_of), and D1 writes leaf 0's
// from the edge alike, so every leaf's value-and-grad reads the bits of
// ops/leaf.py's leaf_drift_torch. The tree alternates two q buffers by the
// leaf's parity, so L2 never writes the q_n it reads (the wrapper and the
// kernel refuse q_next == q_n).
//
// What D1 does not write, because no kernel reads it before writing it in the
// same doubling: the checkpoint rows (an odd leaf of an alive chain reads
// only rows that the even leaves before it wrote; the plain version zeroed
// rows 0..i-1, 3i rows a chain, ~11 MB a depth-9 doubling at 128 chains of
// dim 799 in float32). tests/test_torch_doubling.py fills them with NaN
// before every doubling and gets the same bits. The sub-tree's first leaf,
// which the JAX package keeps and its merge drops, has no buffer. The proposal's copy
// stays: a sub-tree whose leaf 0 has weight +inf takes no leaf and is still
// valid, and then the merge takes the copy (the JAX package's q_prop = q0).
//
// The leaf index lives on the device, as the JAX package's leaf counter is a
// scalar of its while_loop (inference/nuts_batched.py:222-223): counters =
// [k, blocks arrived, condition] (int32), zeroed by D1. The
// leaf's parity is a kernel argument, fixed when a CUDA graph captures the
// launch; L2 derives j = 2k + parity, the checkpoint row hi an
// even leaf writes and the rows lo..hi an odd leaf checks (popcount, trailing
// ones: inference/nuts.py _leaf_idx_to_ckpt_idxs), and the leaf's uniform
// u_leaf[j, c]. On an odd leaf the block that arrives last (one atomic per
// block counts the arrivals and the chains alive; a chain that is not alive
// arrives too) advances k and writes the condition
// k < n_leaves / 2 && any(alive) to counters[2] and,
// given a conditional handle, to the handle: the WHILE node that runs the
// doubling's leaf pairs on the card (ops/graph_if.py). Without a handle (the
// eager tree on the card) it only advances k.
//
// Design. L2 runs one block per chain: a chain's reductions (the kinetic
// energy and two dot products per checkpoint row) are summed by its own
// threads in one fixed order (thread t takes elements t, t + 256, ... in
// order, then a fixed shuffle tree in each warp and the eight warps' sums in
// order), so a chain's bits do not depend on how many chains share the launch,
// as the mesh's sharded-equals-unsharded check and the graphed-equals-eager
// check need. Every thread of the block computes the chain's scalar decisions
// (take, bad, turned) from the same sums, so they need no broadcast, and every
// masked write follows them. A chain that is not alive writes only its
// q_next (every commit of the leaf is masked by alive). The elementwise arithmetic is the
// plain version's, operation for operation, with no FMA contraction
// (__fmul_rn, __fadd_rn, ...), so the leaf state is the plain version's bits
// and only the sums differ from it, by order.
//
// One pass: each thread starts the loads of all its elements (cur's p, v, g
// and mg, q_n, g_n, mg_n or the inverse mass, rho; cur's q when tracking; on
// an odd leaf the first kSweepRows checkpoint rows) before it uses any, forms
// p_n, v_n, mg_n and the new rho once and keeps them: in registers up to
// kRegisterElements elements a thread (dim <= 1024), else in dynamic shared
// memory (three rows of dim: p_n, v_n, rho), else, for a dim whose three rows
// exceed a block's shared memory, in place in cur and rho, which the commit
// writes anyway. The kinetic energy and the first kSweepRows rows' U-turn sums
// take one block reduction. The commits write from the kept values: those
// that do not wait for the chain's decisions (rho, the leaf state, an even
// leaf's checkpoint row) while the reduction runs, in the
// register path, and the proposal and the divergent step after it.
//
// Bound: bytes. Per alive chain L2 reads about seven (C, dim) rows (four of
// cur, q_n, g_n, mg_n, rho) and writes seven (cur, rho, q_next), plus the
// proposal's five rows where it takes, one checkpoint row's three on even leaves or 3 (hi - lo + 1) rows read on odd
// ones; per chain not alive three rows of cur read and q_next written: at
// (C, dim) = (128, 799) float32 about 6-10 MB, 2-3 us at 3.35 TB/s
// (ops/leaf.py commit_bytes counts it per launch). Rows of 799 floats start
// at no common alignment, so the loads stay 4 or 8 bytes, all in flight.
//
// D1 and D2. Both are bound by bytes and by their launch (a few microseconds
// of rows at most). D1 runs one thread per element of each chain's row (a
// grid of (dim / 256, C) blocks): its work is copies and the drift, at any
// order. D2 runs one block per chain, like L2, for the combined U-turn
// check's two row dots, summed in L2's fixed order (block_sum), so a chain's
// decision does not depend on C. Its time is latency: the flags, then the
// rows, then the sums, then the arrival; each thread loads all its elements
// of a chunk (four, a whole row of dim <= 1024) before it stores any, and
// thread 0's scalars fly with them. It reads and writes only what its
// chain's flags select: the moved side's five rows, rho, and where it takes,
// the proposal's five rows (a tracked divergent sub-tree: its step's two
// rows); a chain that is not updated (done before the doubling) touches only
// its scalars. The readout's all-done needs every
// chain: each block's thread 0 arrives on counters[1] (as L2's odd leaves do:
// the arrivals in the low bits, the chains not done from bit kAliveShift), and
// the last to arrive writes the readout, the leaves run from the pair counter
// (1 at depth 0, else 2k), and resets the arrivals. The elementwise and
// scalar arithmetic is the plain versions', operation for operation, with no
// FMA contraction; exp, log1p and logaddexp follow the formulas torch's CUDA
// kernels use. So the state is the plain versions' bits, and only a row dot
// within rounding of 0 can flip the combined U-turn decision.
//
// Stage stamps (utils/trace.py). Each kernel takes the address of the
// tracer's stamp buffer as its last pointer, null unless the tracer was on
// when it was launched or captured. Given one, the launch runs the kernel's
// traced instantiation (kTraced; a null one runs the untraced kernel, which
// holds no stamp): one thread of block 0 stamps the kernel's stage on entry
// (D1 open, L2 commit, D2 merge), closing the stage before it (D1:
// between_graphs; L2: the int trace_prev, fixed at capture; D2: commit), and
// D2's last block to arrive stamps between_graphs on exit. A stamp changes
// nothing the kernels compute.
//
// C interface (ctypes), each in _f32 and _f64, returning a cudaError_t:
//   nuts_leaf_commit_<t>(ptrs, ints, max_delta_energy, stream)
//   nuts_doubling_open_<t>(ptrs, ints, stream)
//   nuts_doubling_merge_<t>(ptrs, ints, stream)
// with ptrs and ints in the order of CommitArgs, OpenArgs and MergeArgs, the
// last two ints the counts of each (kNumPointers and kNumInts for L2,
// kOpenPointers and kOpenInts for D1, kMergePointers and kMergeInts for D2).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // L2: one block of this many per chain
constexpr int kWarps = kThreads / 32;
constexpr int kSweepRows = 4;          // L2: checkpoint rows per block reduction
constexpr int kMaxSums = 1 + 2 * kSweepRows;
constexpr int kRegisterElements = 4;   // L2: elements a thread keeps in registers
constexpr int kStashBytes = 232448 - 1024;  // a block's shared memory, less the static
constexpr int kAliveShift = 15;        // L2: chains a launch, at most 2^15 - 1
constexpr int kNumPointers = 25;
constexpr int kNumInts = 11;

// The tracer's stages (utils/trace.py STAGES) and its stamp: buf = [the
// last stamp's ns, the stage it opened, the first stamp's ns, ns by stage,
// entries by stage], a stage's ns the sum of its ends less its starts. A
// stamp reads %globaltimer, closes stage prev (adds now, counts an entry)
// and opens stage (subtracts now); with mark it also records itself as the
// last stamp (a D2 entry's does not: the last block's exit stamp does). Its
// atomics return nothing the thread waits on, so the stamping thread goes on
// at once; the kernels of a stream run in turn.
constexpr int kStages = 6;
constexpr int kStageOpen = 0, kStageCommit = 3, kStageMerge = 4, kStageBetween = 5;

__device__ __forceinline__ void trace_stamp(int64_t* buf, int prev, int stage, bool mark,
                                            bool first) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  unsigned long long* b = reinterpret_cast<unsigned long long*>(buf);
  if (first) atomicCAS(b + 2, 0ull, now);
  atomicAdd(b + 3 + prev, now);
  atomicAdd(b + 3 + stage, 0ull - now);
  atomicAdd(b + 3 + kStages + prev, 1ull);
  if (mark) {
    b[0] = now;
    b[1] = static_cast<unsigned long long>(stage);
  }
}

// Rounded arithmetic with no contraction, and the math the plain version
// calls, for each type.
template <typename T>
struct Op;

template <>
struct Op<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float exp(float a) { return expf(a); }
  static __device__ __forceinline__ float log1p(float a) { return log1pf(a); }
  static __device__ __forceinline__ float max(float a, float b) { return fmaxf(a, b); }
  static __device__ __forceinline__ float abs(float a) { return fabsf(a); }
};

template <>
struct Op<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double exp(double a) { return ::exp(a); }
  static __device__ __forceinline__ double log1p(double a) { return ::log1p(a); }
  static __device__ __forceinline__ double max(double a, double b) { return fmax(a, b); }
  static __device__ __forceinline__ double abs(double a) { return fabs(a); }
};

// torch.logaddexp's formula: the infinite case, else max + log1p(exp(-|a - b|)).
template <typename T>
__device__ __forceinline__ T log_add_exp(T a, T b) {
  using O = Op<T>;
  const bool a_inf = a == T(INFINITY) || a == T(-INFINITY);
  if (a_inf && a == b) return a;
  return O::add(O::max(a, b), O::log1p(O::exp(-O::abs(O::sub(a, b)))));
}

// Sum x[first..last) over the block, each value in a fixed order (a warp's
// shuffle tree, then the eight warps in order): every thread gets the same
// bits. first and last are the same in every thread.
template <typename T>
__device__ __forceinline__ void block_sum(T (&x)[kMaxSums], int first, int last,
                                          T (*smem)[kWarps]) {
  using O = Op<T>;
#pragma unroll
  for (int s = 0; s < kMaxSums; ++s) {
    if (s >= first && s < last) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x[s] = O::add(x[s], __shfl_xor_sync(0xffffffffu, x[s], o));
    }
  }
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // the previous sum's reads of smem are done
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int s = 0; s < kMaxSums; ++s) {
      if (s >= first && s < last) smem[s][warp] = x[s];
    }
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kMaxSums; ++s) {
    if (s >= first && s < last) {
      x[s] = smem[s][0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) x[s] = O::add(x[s], smem[s][w]);
    }
  }
}

// The leapfrog step's drift of one element, q + step * (v + half * mg), in
// the plain drift's rounded operations; D1 writes leaf 0's q with it, L2 the
// next leaf's.
template <typename T>
__device__ __forceinline__ T drift_of(T h, T step, T q, T v, T mg) {
  using O = Op<T>;
  return O::add(q, O::mul(step, O::add(v, O::mul(h, mg))));
}

template <typename T>
struct CommitArgs {
  // ptrs, in this order
  T* cur;               // (C, 5, dim) the leaf state, in and out
  const T* q_n;         // (C, dim)
  T* q_next;            // (C, dim) out: the next leaf's q, drifted from the committed state
  const T* logp_n;      // (C,)
  const T* g_n;         // (C, dim)
  const T* mg_n;        // (C, dim) M^-1 g_n of a dense metric, or null
  const T* inv_mass;    // a diagonal metric's (dim,) or (C, dim), or null
  const T* half;        // (C,) half the signed step
  const T* step;        // (C,) the signed step
  const T* h0;          // (C,) the transition's start energy
  const T* u_leaf;      // (n_leaves, C) the doubling's uniforms
  T* s_prop;            // (C, 5, dim)
  T* s_logp_prop;       // (C,)
  T* s_rho;             // (C, dim)
  T* ckpts;             // (C, R, 3, dim) = [p, v, rho] per row
  T* s_lsw;             // (C,)
  T* s_sum_accept;      // (C,)
  T* s_n_leaves;        // (C,)
  bool* s_div;          // (C,)
  bool* s_turn;         // (C,)
  bool* alive;          // (C,)
  T* s_div_edge;        // (C, dim) or null (not tracking)
  T* s_div_leaf;        // (C, dim) or null
  int* counters;        // (3,) the pair counter k, the blocks arrived, the loop's condition
  int64_t* trace;     // the tracer's stamp buffer, or null
  // ints, in this order
  int n_chains, dim, n_rows;
  int inv_mass_stride;  // 0 (shared) or dim (per chain)
  int n_leaves;         // the doubling's, 2^i
  int parity;           // the leaf's: j = 2k + parity
  int has_handle;
  cudaGraphConditionalHandle handle;  // the WHILE node's, where has_handle
  int trace_prev;       // the stage the stamp closes (where trace is given)
  T max_delta_energy;
  int stash_in_smem;    // set at launch: kept rows in shared memory, else in place
};

// One chain's rows and its leaf, the same in every thread of its block.
template <typename T>
struct Chain {
  int64_t c, dim;
  int j, lo, hi;  // the leaf, and its checkpoint rows (hi the row an even leaf writes)
  T h, step;
  T *cq, *cp, *cv, *cg, *cmg, *rho, *prop, *ck, *edge, *leaf, *qnext;
  const T *qn, *gn, *mgn, *im;
};

template <typename T>
__device__ __forceinline__ Chain<T> chain_of(const CommitArgs<T>& a, int k) {
  Chain<T> ch;
  ch.c = blockIdx.x;
  ch.dim = a.dim;
  ch.j = 2 * k + a.parity;
  // inference/nuts.py _leaf_idx_to_ckpt_idxs: hi = popcount(j >> 1) =
  // popcount(k), lo = hi - (trailing ones of j) + 1
  ch.hi = __popc(k);
  ch.lo = ch.hi - (__ffs(~ch.j) - 1) + 1;
  if (ch.j >= a.n_leaves || ch.hi >= a.n_rows) __trap();
  const int64_t dim = ch.dim, row = ch.c * dim;
  ch.h = a.half[ch.c];
  ch.step = a.step[ch.c];
  ch.cq = a.cur + ch.c * 5 * dim;
  ch.cp = ch.cq + dim;
  ch.cv = ch.cp + dim;
  ch.cg = ch.cv + dim;
  ch.cmg = ch.cg + dim;
  ch.rho = a.s_rho + row;
  ch.prop = a.s_prop + ch.c * 5 * dim;
  ch.ck = a.ckpts + (ch.c * a.n_rows + ch.hi) * 3 * dim;
  ch.edge = a.s_div_edge ? a.s_div_edge + row : nullptr;
  ch.leaf = a.s_div_leaf ? a.s_div_leaf + row : nullptr;
  ch.qn = a.q_n + row;
  ch.qnext = a.q_next + row;
  ch.gn = a.g_n + row;
  ch.mgn = a.mg_n ? a.mg_n + row : nullptr;
  ch.im = a.inv_mass ? a.inv_mass + ch.c * a.inv_mass_stride : nullptr;
  return ch;
}

// The chain's scalars, read by every thread before the first block sum (whose
// barrier orders them before thread 0's writes of the same scalars).
template <typename T>
struct Scalars {
  T logp, h0, lsw, u;
};

template <typename T>
__device__ __forceinline__ Scalars<T> scalars_of(const CommitArgs<T>& a, const Chain<T>& ch) {
  return {a.logp_n[ch.c], a.h0[ch.c], a.s_lsw[ch.c],
          a.u_leaf[int64_t(ch.j) * a.n_chains + ch.c]};
}

// The chain's decisions from its kinetic energy, the same in every thread.
template <typename T>
struct Decision {
  T logp, lsw, accept;
  bool bad, take;
};

template <typename T>
__device__ __forceinline__ Decision<T> decide(const CommitArgs<T>& a, const Scalars<T>& s,
                                              T kin) {
  using O = Op<T>;
  Decision<T> d;
  d.logp = s.logp;
  const T delta = O::sub(O::add(-s.logp, O::mul(T(0.5), kin)), s.h0);
  d.bad = !(delta <= a.max_delta_energy);  // NaN -> bad
  const T w = d.bad ? T(-INFINITY) : -delta;
  d.accept = d.bad ? T(0) : O::exp(-delta < T(0) ? -delta : T(0));
  d.lsw = log_add_exp(s.lsw, w);
  d.take = s.u < O::exp(O::sub(w, d.lsw));
  return d;
}

// p_n, v_n, the new rho and the kinetic term of one element, from cur's p, v,
// g, mg, rho, g_n and mg_n (mg_n is inv_mass * g_n for a diagonal metric).
template <typename T>
__device__ __forceinline__ void advance(T h, T& p, T& v, T& r, T cg, T cmg, T g, T mg, T& kin) {
  using O = Op<T>;
  p = O::add(O::add(p, O::mul(h, cg)), O::mul(h, g));
  v = O::add(O::add(v, O::mul(h, cmg)), O::mul(h, mg));
  r = O::add(r, p);
  kin = O::add(kin, O::mul(p, v));
}

// One element's terms of one checkpoint row's U-turn sums.
template <typename T>
__device__ __forceinline__ void turn_terms(T rk, T vk, T rhok, T p, T v, T r, T& left, T& right) {
  using O = Op<T>;
  const T rc = O::sub(O::add(O::sub(r, rhok), rk), O::mul(T(0.5), O::add(rk, p)));
  left = O::add(left, O::mul(vk, rc));
  right = O::add(right, O::mul(rc, v));
}

// The commits of one element that do not wait for the chain's decisions
// (every one of an alive chain's, but the proposal's and the divergent
// step's): rho, the leaf state, an even leaf's checkpoint row; and the next
// leaf's q, drifted from the leaf state committed.
template <typename T>
__device__ __forceinline__ void commit_state(const CommitArgs<T>& a, const Chain<T>& ch,
                                             int64_t i, T q, T p, T v, T g, T mg, T r) {
  const int64_t dim = ch.dim;
  ch.qnext[i] = drift_of(ch.h, ch.step, q, v, mg);
  ch.rho[i] = r;
  if (!a.parity) {
    ch.ck[i] = p;
    ch.ck[dim + i] = v;
    ch.ck[2 * dim + i] = r;
  }
  ch.cq[i] = q;
  ch.cp[i] = p;
  ch.cv[i] = v;
  ch.cg[i] = g;
  ch.cmg[i] = mg;
}

// The commits of one element that follow the decisions: the proposal where
// the chain takes the leaf, the divergent step where it diverges (tracked).
template <typename T>
__device__ __forceinline__ void commit_decided(const Chain<T>& ch, const Decision<T>& d,
                                               int64_t i, T q, T p, T v, T g, T mg, T q_old) {
  const int64_t dim = ch.dim;
  if (d.take) {
    ch.prop[i] = q;
    ch.prop[dim + i] = p;
    ch.prop[2 * dim + i] = v;
    ch.prop[3 * dim + i] = g;
    ch.prop[4 * dim + i] = mg;
  }
  if (ch.edge && d.bad) {
    ch.edge[i] = q_old;
    ch.leaf[i] = q;
  }
}

// The chain's sums and flags, written by thread 0 (after the block sums'
// barriers, so every thread has read the old ones); returns the chain's new
// alive flag, the same in every thread.
template <typename T>
__device__ __forceinline__ bool finish(const CommitArgs<T>& a, const Chain<T>& ch,
                                       const Decision<T>& d, bool turned) {
  using O = Op<T>;
  const bool alive = !(d.bad || turned);
  if (threadIdx.x != 0) return alive;
  const int64_t c = ch.c;
  if (d.take) a.s_logp_prop[c] = d.logp;
  a.s_lsw[c] = d.lsw;
  a.s_sum_accept[c] = O::add(a.s_sum_accept[c], d.accept);
  a.s_n_leaves[c] = O::add(a.s_n_leaves[c], T(1));
  if (d.bad) a.s_div[c] = true;
  if (a.parity) a.s_turn[c] = turned;
  a.alive[c] = alive;
  return alive;
}

// An odd leaf's end, thread 0 of every block: one atomic counts the block's
// arrival (low bits) and whether its chain is alive (from bit kAliveShift),
// so the block that arrives last knows any(alive) from what its own atomic
// returns. It advances the pair counter k (read by every block before it
// arrives) and sets the leaf loop's condition k < n_leaves / 2 && any(alive).
template <typename T>
__device__ __forceinline__ void arrive(const CommitArgs<T>& a, int k, bool alive) {
  const int old = atomicAdd(a.counters + 1, 1 + (alive ? 1 << kAliveShift : 0));
  if ((old & ((1 << kAliveShift) - 1)) != a.n_chains - 1) return;
  const bool go = ((old >> kAliveShift) > 0 || alive) && k + 1 < a.n_leaves / 2;
  a.counters[0] = k + 1;
  a.counters[1] = 0;
  a.counters[2] = go;
  if (a.has_handle) cudaGraphSetConditional(a.handle, go ? 1u : 0u);
}

// A thread's E elements of checkpoint rows k0 .. k0 + n - 1 (n <= kSweepRows).
template <typename T, int E>
__device__ __forceinline__ void load_rows(const CommitArgs<T>& a, const Chain<T>& ch, int k0,
                                          int n, T (&rk)[kSweepRows][E],
                                          T (&vk)[kSweepRows][E], T (&rhok)[kSweepRows][E]) {
  const int64_t dim = ch.dim;
#pragma unroll
  for (int s = 0; s < kSweepRows; ++s) {
    const T* row = a.ckpts + (ch.c * a.n_rows + k0 + s) * 3 * dim;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int64_t i = threadIdx.x + e * kThreads;
      const bool in = s < n && i < dim;
      rk[s][e] = in ? row[i] : T(0);
      vk[s][e] = in ? row[dim + i] : T(0);
      rhok[s][e] = in ? row[2 * dim + i] : T(0);
    }
  }
}

// A chain that is not alive keeps its leaf state: the next leaf's q is
// drifted from it.
template <typename T>
__device__ __forceinline__ void drift_frozen(const CommitArgs<T>& a) {
  const int64_t c = blockIdx.x, dim = a.dim;
  const T* s = a.cur + c * 5 * dim;
  T* q_next = a.q_next + c * dim;
  const T h = a.half[c], step = a.step[c];
  for (int64_t i = threadIdx.x; i < dim; i += kThreads) {
    q_next[i] = drift_of(h, step, s[i], s[2 * dim + i], s[4 * dim + i]);
  }
}

// L2 for dim <= E * kThreads: a thread's E elements in registers.
template <typename T, int E, bool kTraced>
__global__ void __launch_bounds__(kThreads) nuts_leaf_commit_kernel(CommitArgs<T> a) {
  __shared__ T smem[kMaxSums][kWarps];
  const int tid = threadIdx.x;
  if (kTraced && blockIdx.x == 0 && tid == 0) {
    trace_stamp(a.trace, a.trace_prev, kStageCommit, true, false);
  }
  const bool alive = a.alive[blockIdx.x];
  const int k = a.counters[0];  // loaded with alive: the rows and u depend on it
  bool alive_after = false;
  if (alive) {
    const Chain<T> ch = chain_of(a, k);
    const int64_t dim = ch.dim;
    const bool track = ch.edge != nullptr;
    T q[E], p[E], v[E], g[E], mg[E], r[E], cg[E], cmg[E], q_old[E];
    T rk[kSweepRows][E], vk[kSweepRows][E], rhok[kSweepRows][E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int64_t i = tid + e * kThreads;
      const bool in = i < dim;
      q[e] = in ? ch.qn[i] : T(0);
      g[e] = in ? ch.gn[i] : T(0);
      mg[e] = in ? (ch.im ? ch.im[i] : ch.mgn[i]) : T(0);
      p[e] = in ? ch.cp[i] : T(0);
      v[e] = in ? ch.cv[i] : T(0);
      cg[e] = in ? ch.cg[i] : T(0);
      cmg[e] = in ? ch.cmg[i] : T(0);
      r[e] = in ? ch.rho[i] : T(0);
      q_old[e] = in && track ? ch.cq[i] : T(0);
    }
    // an odd leaf's first checkpoint rows, loaded with the rest
    load_rows(a, ch, ch.lo, a.parity ? min(kSweepRows, ch.hi - ch.lo + 1) : 0, rk, vk, rhok);
    const Scalars<T> sc = scalars_of(a, ch);

    T sums[kMaxSums];
#pragma unroll
    for (int s = 0; s < kMaxSums; ++s) sums[s] = T(0);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int64_t i = tid + e * kThreads;
      if (i < dim) {
        if (ch.im) mg[e] = Op<T>::mul(mg[e], g[e]);
        advance(ch.h, p[e], v[e], r[e], cg[e], cmg[e], g[e], mg[e], sums[0]);
        commit_state(a, ch, i, q[e], p[e], v[e], g[e], mg[e], r[e]);  // under the sums' latency
      }
    }
    bool turned = false;
    for (int k0 = ch.lo, chunk = 0; chunk == 0 || k0 <= ch.hi; k0 += kSweepRows, ++chunk) {
      const int n = a.parity ? min(kSweepRows, ch.hi - k0 + 1) : 0;
      if (chunk > 0) load_rows(a, ch, k0, n, rk, vk, rhok);  // deep trees' leaves
#pragma unroll
      for (int s = 0; s < kSweepRows; ++s) {
        T left = T(0), right = T(0);
        if (s < n) {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            if (tid + e * kThreads < dim) {
              turn_terms(rk[s][e], vk[s][e], rhok[s][e], p[e], v[e], r[e], left, right);
            }
          }
        }
        sums[1 + 2 * s] = left;
        sums[2 + 2 * s] = right;
      }
      block_sum(sums, chunk == 0 ? 0 : 1, 1 + 2 * n, smem);
#pragma unroll
      for (int s = 0; s < kSweepRows; ++s) {
        if (s < n) turned = turned || sums[1 + 2 * s] <= T(0) || sums[2 + 2 * s] <= T(0);
      }
      if (!a.parity) break;
    }
    const Decision<T> d = decide(a, sc, sums[0]);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int64_t i = tid + e * kThreads;
      if (i < dim) commit_decided(ch, d, i, q[e], p[e], v[e], g[e], mg[e], q_old[e]);
    }
    alive_after = finish(a, ch, d, turned);
  } else {
    drift_frozen(a);
  }
  if (a.parity && tid == 0) arrive(a, k, alive_after);
}

// L2 for any dim: p_n, v_n and the new rho kept in dynamic shared memory
// (three rows of dim) where they fit, else in place in cur's p and v rows and
// rho, which the commit writes anyway.
template <typename T, bool kTraced>
__global__ void __launch_bounds__(kThreads) nuts_leaf_commit_stash_kernel(CommitArgs<T> a) {
  using O = Op<T>;
  __shared__ T smem[kMaxSums][kWarps];
  extern __shared__ __align__(16) unsigned char stash[];
  const int tid = threadIdx.x;
  if (kTraced && blockIdx.x == 0 && tid == 0) {
    trace_stamp(a.trace, a.trace_prev, kStageCommit, true, false);
  }
  const bool alive = a.alive[blockIdx.x];
  const int k = a.counters[0];
  bool alive_after = false;
  if (alive) {
    const Chain<T> ch = chain_of(a, k);
    const int64_t dim = ch.dim;
    T* sp = a.stash_in_smem ? reinterpret_cast<T*>(stash) : ch.cp;
    T* sv = a.stash_in_smem ? sp + dim : ch.cv;
    T* sr = a.stash_in_smem ? sp + 2 * dim : ch.rho;
    const Scalars<T> sc = scalars_of(a, ch);
    T sums[kMaxSums];
#pragma unroll
    for (int s = 0; s < kMaxSums; ++s) sums[s] = T(0);
#pragma unroll 4
    for (int64_t i = tid; i < dim; i += kThreads) {
      const T g = ch.gn[i];
      const T mg = ch.im ? O::mul(ch.im[i], g) : ch.mgn[i];
      T p = ch.cp[i], v = ch.cv[i], r = ch.rho[i];
      advance(ch.h, p, v, r, ch.cg[i], ch.cmg[i], g, mg, sums[0]);
      sp[i] = p;
      sv[i] = v;
      sr[i] = r;
    }
    bool turned = false;
    for (int k0 = ch.lo, chunk = 0; chunk == 0 || k0 <= ch.hi; k0 += kSweepRows, ++chunk) {
      const int n = a.parity ? min(kSweepRows, ch.hi - k0 + 1) : 0;
      for (int64_t i = tid; i < dim; i += kThreads) {
        const T p = sp[i], v = sv[i], r = sr[i];
#pragma unroll
        for (int s = 0; s < kSweepRows; ++s) {
          if (s < n) {
            const T* row = a.ckpts + (ch.c * a.n_rows + k0 + s) * 3 * dim;
            turn_terms(row[i], row[dim + i], row[2 * dim + i], p, v, r, sums[1 + 2 * s],
                       sums[2 + 2 * s]);
          }
        }
      }
      block_sum(sums, chunk == 0 ? 0 : 1, 1 + 2 * n, smem);
#pragma unroll
      for (int s = 0; s < kSweepRows; ++s) {
        if (s < n) turned = turned || sums[1 + 2 * s] <= T(0) || sums[2 + 2 * s] <= T(0);
        sums[1 + 2 * s] = sums[2 + 2 * s] = T(0);  // the next chunk's
      }
      if (!a.parity) break;
    }
    const Decision<T> d = decide(a, sc, sums[0]);
    for (int64_t i = tid; i < dim; i += kThreads) {
      const T q = ch.qn[i], g = ch.gn[i], q_old = ch.cq[i];
      const T mg = ch.im ? O::mul(ch.im[i], g) : ch.mgn[i];
      commit_decided(ch, d, i, q, sp[i], sv[i], g, mg, q_old);
      commit_state(a, ch, i, q, sp[i], sv[i], g, mg, sr[i]);
    }
    alive_after = finish(a, ch, d, turned);
  } else {
    drift_frozen(a);
  }
  if (a.parity && tid == 0) arrive(a, k, alive_after);
}

// L2's launch in its traced or untraced instantiation.
template <typename T, bool kTraced>
int launch_commit(CommitArgs<T> a, cudaStream_t s) {
  if (a.dim <= kThreads) {
    nuts_leaf_commit_kernel<T, 1, kTraced><<<unsigned(a.n_chains), kThreads, 0, s>>>(a);
  } else if (a.dim <= kRegisterElements * kThreads) {
    nuts_leaf_commit_kernel<T, kRegisterElements, kTraced>
        <<<unsigned(a.n_chains), kThreads, 0, s>>>(a);
  } else {
    auto kernel = nuts_leaf_commit_stash_kernel<T, kTraced>;
    static const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStashBytes);
    if (attr != cudaSuccess) return attr;
    const size_t bytes = size_t(3) * a.dim * sizeof(T);
    a.stash_in_smem = bytes <= size_t(kStashBytes);
    kernel<<<unsigned(a.n_chains), kThreads, a.stash_in_smem ? bytes : 0, s>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
int commit(void* const* p, const long long* n, double max_delta_energy, void* stream) {
  CommitArgs<T> a;
  a.cur = static_cast<T*>(p[0]);
  a.q_n = static_cast<const T*>(p[1]);
  a.q_next = static_cast<T*>(p[2]);
  a.logp_n = static_cast<const T*>(p[3]);
  a.g_n = static_cast<const T*>(p[4]);
  a.mg_n = static_cast<const T*>(p[5]);
  a.inv_mass = static_cast<const T*>(p[6]);
  a.half = static_cast<const T*>(p[7]);
  a.step = static_cast<const T*>(p[8]);
  a.h0 = static_cast<const T*>(p[9]);
  a.u_leaf = static_cast<const T*>(p[10]);
  a.s_prop = static_cast<T*>(p[11]);
  a.s_logp_prop = static_cast<T*>(p[12]);
  a.s_rho = static_cast<T*>(p[13]);
  a.ckpts = static_cast<T*>(p[14]);
  a.s_lsw = static_cast<T*>(p[15]);
  a.s_sum_accept = static_cast<T*>(p[16]);
  a.s_n_leaves = static_cast<T*>(p[17]);
  a.s_div = static_cast<bool*>(p[18]);
  a.s_turn = static_cast<bool*>(p[19]);
  a.alive = static_cast<bool*>(p[20]);
  a.s_div_edge = static_cast<T*>(p[21]);
  a.s_div_leaf = static_cast<T*>(p[22]);
  a.counters = static_cast<int*>(p[23]);
  a.trace = static_cast<int64_t*>(p[24]);
  a.n_chains = int(n[0]);
  a.dim = int(n[1]);
  a.n_rows = int(n[2]);
  a.inv_mass_stride = int(n[3]);
  a.n_leaves = int(n[4]);
  a.parity = int(n[5]);
  a.has_handle = int(n[6]);
  a.handle = static_cast<cudaGraphConditionalHandle>(n[7]);
  a.trace_prev = int(n[8]);
  a.max_delta_energy = T(max_delta_energy);
  // exactly one of mg_n and inv_mass; the next leaf's q apart from q_n; the
  // leaf's constants; the interface's counts
  const bool diag = a.inv_mass != nullptr;
  if (diag == (a.mg_n != nullptr) || a.counters == nullptr || a.step == nullptr ||
      a.q_next == nullptr || a.q_next == a.q_n || a.n_rows < 1 ||
      a.n_leaves < 1 || (a.parity != 0 && a.parity != 1) ||
      (a.has_handle != 0 && a.has_handle != 1) || a.n_chains >= (1 << kAliveShift) ||
      (a.trace && (a.trace_prev < 0 || a.trace_prev >= kStages)) ||
      int(n[9]) != kNumPointers || int(n[10]) != kNumInts) {
    return cudaErrorInvalidValue;
  }
  if (a.n_chains == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a.trace ? launch_commit<T, true>(a, s) : launch_commit<T, false>(a, s);
}

// -- D1 and D2: the doubling's opening and its merge ----------------------------

constexpr int kOpenThreads = 256;  // D1: one element of a chain's rows a thread
constexpr int kOpenPointers = 22;
constexpr int kOpenInts = 5;
constexpr int kMergePointers = 28;
constexpr int kMergeElements = 4;  // D2: a thread's elements a chunk, loaded before any store
constexpr int kMergeInts = 7;

template <typename T>
struct OpenArgs {
  // the pointers, in this order
  const T* u;           // (2, C) at row stride u_stride: u[0] the direction's uniforms
  const T* eps;         // (C,) the step sizes
  const T* left;        // (C, 5, dim) the trajectory's edges
  const T* right;       // (C, 5, dim)
  const bool* done;     // (C,)
  T* cur;               // (C, 5, dim) out: the edge in the doubling's direction
  T* s_prop;            // (C, 5, dim) out: the same
  T* q0;                // (C, dim) out: leaf 0's position
  T* half;              // (C,) out: half the signed step
  T* step;              // (C,) out: the signed step
  T* s_rho;             // (C, dim) out: 0
  T* s_logp_prop;       // (C,) out: 0
  T* s_lsw;             // (C,) out: -inf
  T* s_sum_accept;      // (C,) out: 0
  T* s_n_leaves;        // (C,) out: 0
  bool* s_div;          // (C,) out: false
  bool* s_turn;         // (C,) out: false
  bool* alive;          // (C,) out: !done
  T* s_div_edge;        // (C, dim) out: 0, or null (not tracking)
  T* s_div_leaf;        // (C, dim) out: 0, or null
  int* counters;        // (3,) out: 0
  int64_t* trace;     // the tracer's stamp buffer, or null
  // the integers, in this order
  int n_chains, dim, u_stride;
};

template <typename T, bool kTraced>
__global__ void __launch_bounds__(kOpenThreads) nuts_doubling_open_kernel(OpenArgs<T> o) {
  using O = Op<T>;
  const int64_t c = blockIdx.y, dim = o.dim;
  if (kTraced && blockIdx.x == 0 && c == 0 && threadIdx.x == 0) {
    trace_stamp(o.trace, kStageBetween, kStageOpen, true, true);
  }
  // torch.where(u[0] < 0.5, 1.0, -1.0) * eps, and 0.5 times it
  const bool go_right = o.u[c] < T(0.5);
  const T step = O::mul(go_right ? T(1) : T(-1), o.eps[c]);
  const T h = O::mul(T(0.5), step);
  const int64_t i = int64_t(blockIdx.x) * kOpenThreads + threadIdx.x;
  if (i < dim) {
    const T* edge = (go_right ? o.right : o.left) + c * 5 * dim + i;
    T* cur = o.cur + c * 5 * dim + i;
    T* prop = o.s_prop + c * 5 * dim + i;
    T x[5];
#pragma unroll
    for (int r = 0; r < 5; ++r) x[r] = edge[r * dim];
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      cur[r * dim] = x[r];
      prop[r * dim] = x[r];
    }
    o.q0[c * dim + i] = drift_of(h, step, x[0], x[2], x[4]);
    o.s_rho[c * dim + i] = T(0);
    if (o.s_div_edge) {
      o.s_div_edge[c * dim + i] = T(0);
      o.s_div_leaf[c * dim + i] = T(0);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    o.half[c] = h;
    o.step[c] = step;
    o.s_logp_prop[c] = T(0);
    o.s_lsw[c] = T(-INFINITY);
    o.s_sum_accept[c] = T(0);
    o.s_n_leaves[c] = T(0);
    o.s_div[c] = false;
    o.s_turn[c] = false;
    o.alive[c] = !o.done[c];
    if (c == 0) o.counters[0] = o.counters[1] = o.counters[2] = 0;
  }
}

template <typename T>
struct MergeArgs {
  // the pointers, in this order
  const T* u;             // (2, C) at row stride u_stride: the direction's and the merge's
  const T* cur;           // (C, 5, dim) the sub-tree's last leaf, the new edge
  const T* s_prop;        // (C, 5, dim) the sub-tree's proposal
  const T* s_rho;         // (C, dim)
  const T* s_lsw;         // (C,)
  const T* s_logp_prop;   // (C,)
  const T* s_sum_accept;  // (C,)
  const T* s_n_leaves;    // (C,)
  const bool* s_div;      // (C,)
  const bool* s_turn;     // (C,)
  const T* s_div_edge;    // (C, dim) or null (not tracking)
  const T* s_div_leaf;    // (C, dim) or null
  T* left;                // (C, 5, dim) the trajectory's edges, in and out
  T* right;               // (C, 5, dim)
  T* prop;                // (C, 5, dim) the proposal
  T* rho;                 // (C, dim)
  T* logp_prop;           // (C,)
  T* log_sum_w;           // (C,)
  T* sum_accept;          // (C,)
  T* num_leaves;          // (C,)
  bool* diverging;        // (C,)
  bool* done;             // (C,)
  int* depth;             // (C,) int32
  T* div_edge;            // (C, dim) or null
  T* div_leaf;            // (C, dim) or null
  int* counters;          // (3,) the pair counter k, the blocks arrived, the loop's condition
  int64_t* readout;       // (2,) out: all chains done, the leaves run
  int64_t* trace;       // the tracer's stamp buffer, or null
  // the integers, in this order
  int n_chains, dim, u_stride;
  int n_leaves;           // the doubling's, 2^i
  int new_depth;          // i + 1
};

template <typename T, bool kTraced>
__global__ void __launch_bounds__(kThreads) nuts_doubling_merge_kernel(MergeArgs<T> m) {
  using O = Op<T>;
  __shared__ T smem[kMaxSums][kWarps];
  const int tid = threadIdx.x;
  const int64_t c = blockIdx.x, dim = m.dim, row = c * dim, rows = c * 5 * dim;
  if (kTraced && c == 0 && tid == 0) {
    trace_stamp(m.trace, kStageCommit, kStageMerge, false, false);
  }
  // the chain's flags and scalars, the same in every thread (read before the
  // barrier below, after which thread 0 writes them)
  const bool upd = !m.done[c];
  const bool s_div = m.s_div[c], s_turn = m.s_turn[c];
  const bool valid = upd && !(s_div || s_turn);
  const T lsw = m.log_sum_w[c], s_lsw = m.s_lsw[c];
  const T ratio = O::sub(s_lsw, lsw);
  // torch.clamp(max=0) keeps a NaN
  const bool take = valid && m.u[m.u_stride + c] < O::exp(ratio > T(0) ? T(0) : ratio);
  const bool go_right = m.u[c] < T(0.5);
  // thread 0's scalars, in flight with the rows
  T sum_accept = T(0), num_leaves = T(0), s_sum_accept = T(0), s_n_leaves = T(0);
  T s_logp_prop = T(0);
  if (tid == 0) {
    sum_accept = m.sum_accept[c];
    num_leaves = m.num_leaves[c];
    s_sum_accept = m.s_sum_accept[c];
    s_n_leaves = m.s_n_leaves[c];
    s_logp_prop = m.s_logp_prop[c];
  }
  T sums[kMaxSums];
#pragma unroll
  for (int s = 0; s < kMaxSums; ++s) sums[s] = T(0);
  if (valid) {
    // the new edge is cur on the side that moved; the other side stays.
    // A thread's kMergeElements elements a chunk, every load of the chunk
    // before its first store
    T* moved = (go_right ? m.right : m.left) + rows;
    const T* kept = (go_right ? m.left : m.right) + rows;
    const T* cur = m.cur + rows;
    for (int64_t base = 0; base < dim; base += kMergeElements * kThreads) {
      T x[kMergeElements][5], prop[kMergeElements][5], kp[kMergeElements], kv[kMergeElements];
      T rho[kMergeElements], s_rho[kMergeElements];
#pragma unroll
      for (int e = 0; e < kMergeElements; ++e) {
        const int64_t i = base + tid + e * kThreads;
        const bool in = i < dim;
#pragma unroll
        for (int k = 0; k < 5; ++k) {
          x[e][k] = in ? cur[k * dim + i] : T(0);
          prop[e][k] = in && take ? m.s_prop[rows + k * dim + i] : T(0);
        }
        kp[e] = in ? kept[dim + i] : T(0);
        kv[e] = in ? kept[2 * dim + i] : T(0);
        rho[e] = in ? m.rho[row + i] : T(0);
        s_rho[e] = in ? m.s_rho[row + i] : T(0);
      }
#pragma unroll
      for (int e = 0; e < kMergeElements; ++e) {
        const int64_t i = base + tid + e * kThreads;
        if (i >= dim) continue;
        const T cp = x[e][1], cv = x[e][2];
        const T p_left = go_right ? kp[e] : cp, v_left = go_right ? kv[e] : cv;
        const T p_right = go_right ? cp : kp[e], v_right = go_right ? cv : kv[e];
        const T r = O::add(rho[e], s_rho[e]);
        const T rc = O::sub(r, O::mul(T(0.5), O::add(p_left, p_right)));
        sums[0] = O::add(sums[0], O::mul(v_left, rc));
        sums[1] = O::add(sums[1], O::mul(v_right, rc));
        m.rho[row + i] = r;
#pragma unroll
        for (int k = 0; k < 5; ++k) {
          moved[k * dim + i] = x[e][k];
          if (take) m.prop[rows + k * dim + i] = prop[e][k];
        }
      }
    }
  } else if (upd && s_div && m.div_edge) {
    // one divergent sub-tree at most a transition: done is set below
    for (int64_t i = tid; i < dim; i += kThreads) {
      m.div_edge[row + i] = m.s_div_edge[row + i];
      m.div_leaf[row + i] = m.s_div_leaf[row + i];
    }
  }
  bool turning = false;
  if (valid) {  // the same in every thread of the block
    block_sum(sums, 0, 2, smem);
    turning = sums[0] <= T(0) || sums[1] <= T(0);
  }
  __syncthreads();  // every thread has read the chain's flags and scalars
  if (tid != 0) return;
  if (take) m.logp_prop[c] = s_logp_prop;
  if (valid) m.log_sum_w[c] = log_add_exp(lsw, s_lsw);
  m.sum_accept[c] = O::add(sum_accept, upd ? s_sum_accept : T(0));
  m.num_leaves[c] = O::add(num_leaves, upd ? s_n_leaves : T(0));
  if (upd && s_div) m.diverging[c] = true;
  const bool done = !upd || s_div || s_turn || turning;
  m.done[c] = done;
  if (upd) m.depth[c] = m.new_depth;
  // the readout, by the block that arrives last
  const int old = atomicAdd(m.counters + 1, 1 + (done ? 0 : 1 << kAliveShift));
  if ((old & ((1 << kAliveShift) - 1)) != m.n_chains - 1) return;
  m.readout[0] = done && (old >> kAliveShift) == 0;
  m.readout[1] = m.n_leaves == 1 ? 1 : 2 * int64_t(m.counters[0]);
  m.counters[1] = 0;
  if (kTraced) trace_stamp(m.trace, kStageMerge, kStageBetween, true, false);
}

template <typename T>
int open_doubling(void* const* p, const long long* n, void* stream) {
  OpenArgs<T> o;
  o.u = static_cast<const T*>(p[0]);
  o.eps = static_cast<const T*>(p[1]);
  o.left = static_cast<const T*>(p[2]);
  o.right = static_cast<const T*>(p[3]);
  o.done = static_cast<const bool*>(p[4]);
  o.cur = static_cast<T*>(p[5]);
  o.s_prop = static_cast<T*>(p[6]);
  o.q0 = static_cast<T*>(p[7]);
  o.half = static_cast<T*>(p[8]);
  o.step = static_cast<T*>(p[9]);
  o.s_rho = static_cast<T*>(p[10]);
  o.s_logp_prop = static_cast<T*>(p[11]);
  o.s_lsw = static_cast<T*>(p[12]);
  o.s_sum_accept = static_cast<T*>(p[13]);
  o.s_n_leaves = static_cast<T*>(p[14]);
  o.s_div = static_cast<bool*>(p[15]);
  o.s_turn = static_cast<bool*>(p[16]);
  o.alive = static_cast<bool*>(p[17]);
  o.s_div_edge = static_cast<T*>(p[18]);
  o.s_div_leaf = static_cast<T*>(p[19]);
  o.counters = static_cast<int*>(p[20]);
  o.trace = static_cast<int64_t*>(p[21]);
  o.n_chains = int(n[0]);
  o.dim = int(n[1]);
  o.u_stride = int(n[2]);
  // every buffer but the tracked pair, which comes both or neither, and the
  // stamp buffer; the interface's counts
  for (int k = 0; k < kOpenPointers; ++k) {
    if (p[k] == nullptr && k != 18 && k != 19 && k != 21) return cudaErrorInvalidValue;
  }
  if ((o.s_div_edge == nullptr) != (o.s_div_leaf == nullptr) || o.dim < 1 ||
      o.n_chains > 65535 || int(n[3]) != kOpenPointers || int(n[4]) != kOpenInts) {
    return cudaErrorInvalidValue;
  }
  if (o.n_chains == 0) return 0;
  const dim3 grid(unsigned((o.dim + kOpenThreads - 1) / kOpenThreads), unsigned(o.n_chains));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (o.trace) {
    nuts_doubling_open_kernel<T, true><<<grid, kOpenThreads, 0, s>>>(o);
  } else {
    nuts_doubling_open_kernel<T, false><<<grid, kOpenThreads, 0, s>>>(o);
  }
  return cudaGetLastError();
}

template <typename T>
int merge_doubling(void* const* p, const long long* n, void* stream) {
  MergeArgs<T> m;
  m.u = static_cast<const T*>(p[0]);
  m.cur = static_cast<const T*>(p[1]);
  m.s_prop = static_cast<const T*>(p[2]);
  m.s_rho = static_cast<const T*>(p[3]);
  m.s_lsw = static_cast<const T*>(p[4]);
  m.s_logp_prop = static_cast<const T*>(p[5]);
  m.s_sum_accept = static_cast<const T*>(p[6]);
  m.s_n_leaves = static_cast<const T*>(p[7]);
  m.s_div = static_cast<const bool*>(p[8]);
  m.s_turn = static_cast<const bool*>(p[9]);
  m.s_div_edge = static_cast<const T*>(p[10]);
  m.s_div_leaf = static_cast<const T*>(p[11]);
  m.left = static_cast<T*>(p[12]);
  m.right = static_cast<T*>(p[13]);
  m.prop = static_cast<T*>(p[14]);
  m.rho = static_cast<T*>(p[15]);
  m.logp_prop = static_cast<T*>(p[16]);
  m.log_sum_w = static_cast<T*>(p[17]);
  m.sum_accept = static_cast<T*>(p[18]);
  m.num_leaves = static_cast<T*>(p[19]);
  m.diverging = static_cast<bool*>(p[20]);
  m.done = static_cast<bool*>(p[21]);
  m.depth = static_cast<int*>(p[22]);
  m.div_edge = static_cast<T*>(p[23]);
  m.div_leaf = static_cast<T*>(p[24]);
  m.counters = static_cast<int*>(p[25]);
  m.readout = static_cast<int64_t*>(p[26]);
  m.trace = static_cast<int64_t*>(p[27]);
  m.n_chains = int(n[0]);
  m.dim = int(n[1]);
  m.u_stride = int(n[2]);
  m.n_leaves = int(n[3]);
  m.new_depth = int(n[4]);
  // every buffer but the four tracked ones, which come all or none, and the
  // stamp buffer; the interface's counts
  const bool tracked = m.s_div_edge != nullptr;
  for (int k = 0; k < kMergePointers - 1; ++k) {
    const bool track_buffer = k == 10 || k == 11 || k == 23 || k == 24;
    if (track_buffer ? (p[k] != nullptr) != tracked : p[k] == nullptr) {
      return cudaErrorInvalidValue;
    }
  }
  if (m.dim < 1 || m.n_leaves < 1 || m.n_chains >= (1 << kAliveShift) ||
      int(n[5]) != kMergePointers || int(n[6]) != kMergeInts) {
    return cudaErrorInvalidValue;
  }
  if (m.n_chains == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m.trace) {
    nuts_doubling_merge_kernel<T, true><<<unsigned(m.n_chains), kThreads, 0, s>>>(m);
  } else {
    nuts_doubling_merge_kernel<T, false><<<unsigned(m.n_chains), kThreads, 0, s>>>(m);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int nuts_leaf_commit_f32(void* const* ptrs, const long long* ints, double max_delta_energy,
                         void* stream) {
  return commit<float>(ptrs, ints, max_delta_energy, stream);
}

int nuts_leaf_commit_f64(void* const* ptrs, const long long* ints, double max_delta_energy,
                         void* stream) {
  return commit<double>(ptrs, ints, max_delta_energy, stream);
}

int nuts_doubling_open_f32(void* const* ptrs, const long long* ints, void* stream) {
  return open_doubling<float>(ptrs, ints, stream);
}

int nuts_doubling_open_f64(void* const* ptrs, const long long* ints, void* stream) {
  return open_doubling<double>(ptrs, ints, stream);
}

int nuts_doubling_merge_f32(void* const* ptrs, const long long* ints, void* stream) {
  return merge_doubling<float>(ptrs, ints, stream);
}

int nuts_doubling_merge_f64(void* const* ptrs, const long long* ints, void* stream) {
  return merge_doubling<double>(ptrs, ints, stream);
}

}  // extern "C"
