// The NUTS leaf of the batched tree (sm_90a): two kernels that take the place
// of the JAX package's fused leaf body, the body of _build_subtree_b's
// lax.while_loop in inference/nuts_batched.py (:225-302), which XLA compiles
// into a few fused loops over the (C, dim) state. The port's plain versions
// are ops/leaf.py's leaf_drift_torch and leaf_commit_torch (about 60 small
// kernels a leaf on the card); the tree is inference/nuts_batched.py's
// LockstepTree.
//
//   L1 nuts_leaf_drift   q_n = q + step * (v + half * mg), from the packed leaf
//                        state cur (C, 5, dim) = [q, p, v, grad, M^-1 grad]
//                        and the (C,) signed step and half step;
//   L2 nuts_leaf_commit  after the value-and-grad at q_n (and, for a dense
//                        metric, its product M^-1 g_n): p_n and v_n, the
//                        energy error, divergence (NaN counts as divergent),
//                        the multinomial weight, its log-sum-exp and the
//                        take against the leaf's uniform, the masked commits
//                        of the proposal, rho, the first leaf, the checkpoint
//                        row (even leaves) or the U-turn sweep over the
//                        checkpoint rows lo..hi (odd leaves), the divergent
//                        step when tracked, the leaf state, the sub-tree's
//                        sums and flags, and alive &= ~stop. For a diagonal
//                        metric it also computes mg_n = inv_mass * g_n, with
//                        inv_mass shared (chain stride 0) or per chain. On an
//                        odd leaf it also advances the doubling's pair counter
//                        and sets the leaf loop's condition (below). Last, it
//                        writes the next leaf's q_next = L1 of the committed
//                        leaf state, for every chain (below).
//
// L1's fold into L2. The step is a constant of the doubling, so the drift of
// leaf j + 1 needs nothing that leaf j's commit does not hold: L2 writes
// q_next from the leaf state it commits (q_n, v_n, mg_n of a chain alive;
// cur's q, v, mg of a chain that is not, whose state stays) with L1's rounded
// operations in L1's order (drift_of), so q_next is L1's output bit for bit
// and the value-and-grad of the next leaf reads what it read after L1. Only
// leaf 0 of a doubling runs L1 (the direction is drawn before it). The tree
// alternates two q buffers by the leaf's parity, so L2 never writes the q_n
// it reads (the wrapper and the kernel refuse q_next == q_n).
//
// The leaf index lives on the device, as the JAX package's leaf counter is a
// scalar of its while_loop (inference/nuts_batched.py:222-223): counters =
// [k, blocks arrived, condition] (int32), k reset by the doubling's setup. The
// leaf's parity and j == 0 are kernel arguments, fixed when a CUDA graph
// captures the launch; L2 derives j = 2k + parity, the checkpoint row hi an
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
// that do not wait for the chain's decisions (rho, the leaf state, the first
// leaf, an even leaf's checkpoint row) while the reduction runs, in the
// register path, and the proposal and the divergent step after it.
//
// Bound: bytes. Per alive chain L2 reads about seven (C, dim) rows (four of
// cur, q_n, g_n, mg_n, rho) and writes seven (cur, rho, q_next), plus the
// proposal's five rows where it takes, the first leaf's five at j = 0, one
// checkpoint row's three on even leaves or 3 (hi - lo + 1) rows read on odd
// ones; per chain not alive three rows of cur read and q_next written: at
// (C, dim) = (128, 799) float32 about 6-10 MB, 2-3 us at 3.35 TB/s
// (ops/leaf.py commit_bytes counts it per launch). Rows of 799 floats start
// at no common alignment, so the loads stay 4 or 8 bytes, all in flight.
//
// C interface (ctypes), each in _f32 and _f64, returning a cudaError_t:
//   nuts_leaf_drift_<t>(cur, half, step, q_n, n_chains, dim, stream)
//   nuts_leaf_commit_<t>(ptrs, ints, max_delta_energy, stream)
// with ptrs[kNumPointers] and ints[kNumInts] in the order of CommitArgs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // L2: one block of this many per chain
constexpr int kWarps = kThreads / 32;
constexpr int kDriftThreads = 256;     // L1: one element a thread
constexpr int kSweepRows = 4;          // L2: checkpoint rows per block reduction
constexpr int kMaxSums = 1 + 2 * kSweepRows;
constexpr int kRegisterElements = 4;   // L2: elements a thread keeps in registers
constexpr int kStashBytes = 232448 - 1024;  // a block's shared memory, less the static
constexpr int kAliveShift = 15;        // L2: chains a launch, at most 2^15 - 1
constexpr int kNumPointers = 25;
constexpr int kNumInts = 11;

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
// L1's rounded operations; L2 writes the next leaf's q with it.
template <typename T>
__device__ __forceinline__ T drift_of(T h, T step, T q, T v, T mg) {
  using O = Op<T>;
  return O::add(q, O::mul(step, O::add(v, O::mul(h, mg))));
}

template <typename T>
__global__ void __launch_bounds__(kDriftThreads)
    nuts_leaf_drift_kernel(const T* __restrict__ cur, const T* __restrict__ half,
                           const T* __restrict__ step, T* __restrict__ q_n, int n_chains,
                           int dim) {
  const int64_t total = int64_t(n_chains) * dim;
  for (int64_t k = int64_t(blockIdx.x) * kDriftThreads + threadIdx.x; k < total;
       k += int64_t(gridDim.x) * kDriftThreads) {
    const int64_t c = k / dim;
    const int64_t i = k - c * dim;
    const T* s = cur + c * 5 * dim;
    q_n[k] = drift_of(half[c], step[c], s[i], s[2 * dim + i], s[4 * dim + i]);
  }
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
  T* first;             // (C, 5, dim)
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
  // ints, in this order
  int n_chains, dim, n_rows;
  int inv_mass_stride;  // 0 (shared) or dim (per chain)
  int n_leaves;         // the doubling's, 2^i
  int parity, is_first;  // the leaf's: j = 2k + parity, and j == 0
  int has_handle;
  cudaGraphConditionalHandle handle;  // the WHILE node's, where has_handle
  T max_delta_energy;
  int stash_in_smem;    // set at launch: kept rows in shared memory, else in place
};

// One chain's rows and its leaf, the same in every thread of its block.
template <typename T>
struct Chain {
  int64_t c, dim;
  int j, lo, hi;  // the leaf, and its checkpoint rows (hi the row an even leaf writes)
  T h, step;
  T *cq, *cp, *cv, *cg, *cmg, *rho, *prop, *first, *ck, *edge, *leaf, *qnext;
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
  if (ch.j >= a.n_leaves || ch.hi >= a.n_rows || (ch.j == 0) != (a.is_first != 0)) __trap();
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
  ch.first = a.first + ch.c * 5 * dim;
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
// step's): rho, the leaf state, the first leaf, an even leaf's checkpoint
// row; and the next leaf's q, drifted from the leaf state committed.
template <typename T>
__device__ __forceinline__ void commit_state(const CommitArgs<T>& a, const Chain<T>& ch,
                                             int64_t i, T q, T p, T v, T g, T mg, T r) {
  const int64_t dim = ch.dim;
  ch.qnext[i] = drift_of(ch.h, ch.step, q, v, mg);
  ch.rho[i] = r;
  if (a.is_first) {
    ch.first[i] = q;
    ch.first[dim + i] = p;
    ch.first[2 * dim + i] = v;
    ch.first[3 * dim + i] = g;
    ch.first[4 * dim + i] = mg;
  }
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
// drifted from it, as L1 would drift it.
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
template <typename T, int E>
__global__ void __launch_bounds__(kThreads) nuts_leaf_commit_kernel(CommitArgs<T> a) {
  __shared__ T smem[kMaxSums][kWarps];
  const int tid = threadIdx.x;
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
template <typename T>
__global__ void __launch_bounds__(kThreads) nuts_leaf_commit_stash_kernel(CommitArgs<T> a) {
  using O = Op<T>;
  __shared__ T smem[kMaxSums][kWarps];
  extern __shared__ __align__(16) unsigned char stash[];
  const int tid = threadIdx.x;
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

template <typename T>
int drift(const void* cur, const void* half, const void* step, void* q_n, int n_chains, int dim,
          void* stream) {
  const int64_t total = int64_t(n_chains) * dim;
  if (total == 0) return 0;
  const int64_t blocks = (total + kDriftThreads - 1) / kDriftThreads;
  nuts_leaf_drift_kernel<T><<<unsigned(blocks < 65535 ? blocks : 65535), kDriftThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(cur), static_cast<const T*>(half), static_cast<const T*>(step),
      static_cast<T*>(q_n), n_chains, dim);
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
  a.first = static_cast<T*>(p[14]);
  a.ckpts = static_cast<T*>(p[15]);
  a.s_lsw = static_cast<T*>(p[16]);
  a.s_sum_accept = static_cast<T*>(p[17]);
  a.s_n_leaves = static_cast<T*>(p[18]);
  a.s_div = static_cast<bool*>(p[19]);
  a.s_turn = static_cast<bool*>(p[20]);
  a.alive = static_cast<bool*>(p[21]);
  a.s_div_edge = static_cast<T*>(p[22]);
  a.s_div_leaf = static_cast<T*>(p[23]);
  a.counters = static_cast<int*>(p[24]);
  a.n_chains = int(n[0]);
  a.dim = int(n[1]);
  a.n_rows = int(n[2]);
  a.inv_mass_stride = int(n[3]);
  a.n_leaves = int(n[4]);
  a.parity = int(n[5]);
  a.is_first = int(n[6]);
  a.has_handle = int(n[7]);
  a.handle = static_cast<cudaGraphConditionalHandle>(n[8]);
  a.max_delta_energy = T(max_delta_energy);
  // exactly one of mg_n and inv_mass; the next leaf's q apart from q_n; the
  // leaf's constants; the interface's counts
  const bool diag = a.inv_mass != nullptr;
  if (diag == (a.mg_n != nullptr) || a.counters == nullptr || a.step == nullptr ||
      a.q_next == nullptr || a.q_next == a.q_n || a.n_rows < 1 ||
      a.n_leaves < 1 || (a.parity != 0 && a.parity != 1) || (a.is_first && a.parity) ||
      (a.has_handle != 0 && a.has_handle != 1) || a.n_chains >= (1 << kAliveShift) ||
      int(n[9]) != kNumPointers ||
      int(n[10]) != kNumInts) {
    return cudaErrorInvalidValue;
  }
  if (a.n_chains == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.dim <= kThreads) {
    nuts_leaf_commit_kernel<T, 1><<<unsigned(a.n_chains), kThreads, 0, s>>>(a);
  } else if (a.dim <= kRegisterElements * kThreads) {
    nuts_leaf_commit_kernel<T, kRegisterElements><<<unsigned(a.n_chains), kThreads, 0, s>>>(a);
  } else {
    auto kernel = nuts_leaf_commit_stash_kernel<T>;
    static const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStashBytes);
    if (attr != cudaSuccess) return attr;
    const size_t bytes = size_t(3) * a.dim * sizeof(T);
    a.stash_in_smem = bytes <= size_t(kStashBytes);
    kernel<<<unsigned(a.n_chains), kThreads, a.stash_in_smem ? bytes : 0, s>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int nuts_leaf_drift_f32(const void* cur, const void* half, const void* step, void* q_n,
                        int n_chains, int dim, void* stream) {
  return drift<float>(cur, half, step, q_n, n_chains, dim, stream);
}

int nuts_leaf_drift_f64(const void* cur, const void* half, const void* step, void* q_n,
                        int n_chains, int dim, void* stream) {
  return drift<double>(cur, half, step, q_n, n_chains, dim, stream);
}

int nuts_leaf_commit_f32(void* const* ptrs, const long long* ints, double max_delta_energy,
                         void* stream) {
  return commit<float>(ptrs, ints, max_delta_energy, stream);
}

int nuts_leaf_commit_f64(void* const* ptrs, const long long* ints, double max_delta_energy,
                         void* stream) {
  return commit<double>(ptrs, ints, max_delta_energy, stream);
}

}  // extern "C"
