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
//                        inv_mass shared (chain stride 0) or per chain.
//
// Every per-leaf constant (the leaf index j, its parity, j == 0, the write row
// and lo..hi) is a kernel argument, fixed when a CUDA graph captures the
// launch, as the JAX package's leaf counter is an unbatched scalar.
//
// Design. L2 runs one block per chain: a chain's reductions (the kinetic
// energy and two dot products per checkpoint row) are summed by its own
// threads in one fixed order (thread t takes elements t, t + 256, ... in
// order, then a fixed shuffle tree in each warp and the eight warps' sums in
// order), so a chain's bits do not depend on how many chains share the launch,
// as the mesh's sharded-equals-unsharded check and the graphed-equals-eager
// check need. Every thread of the block computes the chain's scalar decisions
// (take, bad, turned) from the same sums, so they need no broadcast, and every
// masked write follows them. A chain that is not alive writes nothing (every
// commit of the leaf is masked by alive), so its block returns at once. The
// elementwise arithmetic is the plain version's, operation for operation,
// with no FMA contraction (__fmul_rn, __fadd_rn, ...), so the leaf state is
// the plain version's bits and only the sums differ from it, by order.
//
// Bound: bytes. Per alive chain L2 reads about seven (C, dim) rows (four of
// cur, q_n, g_n, mg_n, rho) and writes six (cur, rho), plus the proposal's
// five rows where it takes, the first leaf's five at j = 0, one checkpoint
// row's three on even leaves or 3 (hi - lo + 1) rows read on odd ones: at
// (C, dim) = (128, 799) float32 about 6-10 MB, 2-3 us at 3.35 TB/s
// (ops/leaf.py commit_bytes counts it per launch). A simple kernel first: one
// block per chain and re-reads of the rows it needs, no vector loads.
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
constexpr int kNumPointers = 22;
constexpr int kNumInts = 9;

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

// Sum over the block in a fixed order: every thread gets the same bits.
template <typename T>
__device__ __forceinline__ void block_sum2(T& x, T& y, T (*smem)[kWarps]) {
  using O = Op<T>;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x = O::add(x, __shfl_xor_sync(0xffffffffu, x, o));
    y = O::add(y, __shfl_xor_sync(0xffffffffu, y, o));
  }
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // the previous sum's reads of smem are done
  if ((threadIdx.x & 31) == 0) {
    smem[0][warp] = x;
    smem[1][warp] = y;
  }
  __syncthreads();
  x = smem[0][0];
  y = smem[1][0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    x = O::add(x, smem[0][w]);
    y = O::add(y, smem[1][w]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kDriftThreads)
    nuts_leaf_drift_kernel(const T* __restrict__ cur, const T* __restrict__ half,
                           const T* __restrict__ step, T* __restrict__ q_n, int n_chains,
                           int dim) {
  using O = Op<T>;
  const int64_t total = int64_t(n_chains) * dim;
  for (int64_t k = int64_t(blockIdx.x) * kDriftThreads + threadIdx.x; k < total;
       k += int64_t(gridDim.x) * kDriftThreads) {
    const int64_t c = k / dim;
    const int64_t i = k - c * dim;
    const T* s = cur + c * 5 * dim;
    const T v_half = O::add(s[2 * dim + i], O::mul(half[c], s[4 * dim + i]));
    q_n[k] = O::add(s[i], O::mul(step[c], v_half));
  }
}

template <typename T>
struct CommitArgs {
  // ptrs, in this order
  T* cur;               // (C, 5, dim) the leaf state, in and out
  const T* q_n;         // (C, dim)
  const T* logp_n;      // (C,)
  const T* g_n;         // (C, dim)
  const T* mg_n;        // (C, dim) M^-1 g_n of a dense metric, or null
  const T* inv_mass;    // a diagonal metric's (dim,) or (C, dim), or null
  const T* half;        // (C,) half the signed step
  const T* h0;          // (C,) the transition's start energy
  const T* u;           // (C,) this leaf's uniforms
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
  // ints, in this order
  int n_chains, dim, n_rows;
  int inv_mass_stride;  // 0 (shared) or dim (per chain)
  int j, is_first, is_even, lo, hi;  // hi is the write row on an even leaf
  T max_delta_energy;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) nuts_leaf_commit_kernel(CommitArgs<T> a) {
  using O = Op<T>;
  __shared__ T smem[2][kWarps];
  const int64_t c = blockIdx.x;
  if (!a.alive[c]) return;  // every commit of the leaf is masked by alive
  const int tid = threadIdx.x;
  const int64_t dim = a.dim;
  const int64_t row = c * dim;
  T* cq = a.cur + c * 5 * dim;
  T* cp = cq + dim;
  T* cv = cp + dim;
  T* cg = cv + dim;
  T* cmg = cg + dim;
  const T* qn = a.q_n + row;
  const T* gn = a.g_n + row;
  const T* mgn = a.mg_n ? a.mg_n + row : nullptr;
  const T* im = a.inv_mass ? a.inv_mass + c * a.inv_mass_stride : nullptr;
  T* rho = a.s_rho + row;
  const T h = a.half[c];

  // the kinetic energy 0.5 p_n . v_n
  T kin = T(0), unused = T(0);
  for (int64_t i = tid; i < dim; i += kThreads) {
    const T g = gn[i];
    const T mg = im ? O::mul(im[i], g) : mgn[i];
    const T p = O::add(O::add(cp[i], O::mul(h, cg[i])), O::mul(h, g));
    const T v = O::add(O::add(cv[i], O::mul(h, cmg[i])), O::mul(h, mg));
    kin = O::add(kin, O::mul(p, v));
  }
  block_sum2(kin, unused, smem);

  // the chain's decisions, the same in every thread
  const T logp = a.logp_n[c];
  const T delta = O::sub(O::add(-logp, O::mul(T(0.5), kin)), a.h0[c]);
  const bool bad = !(delta <= a.max_delta_energy);  // NaN -> bad
  const T w = bad ? T(-INFINITY) : -delta;
  const T accept = bad ? T(0) : O::exp(-delta < T(0) ? -delta : T(0));
  const T lsw = log_add_exp(a.s_lsw[c], w);
  const bool take = a.u[c] < O::exp(O::sub(w, lsw));
  const bool track = a.s_div_edge != nullptr;

  // the masked commits; cur's old q is read before it is overwritten
  T* prop = a.s_prop + c * 5 * dim;
  T* first = a.first + c * 5 * dim;
  T* ck = a.ckpts + (c * a.n_rows + a.hi) * 3 * dim;
  for (int64_t i = tid; i < dim; i += kThreads) {
    const T q_old = cq[i];
    const T q = qn[i];
    const T g = gn[i];
    const T mg = im ? O::mul(im[i], g) : mgn[i];
    const T p = O::add(O::add(cp[i], O::mul(h, cg[i])), O::mul(h, g));
    const T v = O::add(O::add(cv[i], O::mul(h, cmg[i])), O::mul(h, mg));
    const T r = O::add(rho[i], p);
    rho[i] = r;
    if (take) {
      prop[i] = q;
      prop[dim + i] = p;
      prop[2 * dim + i] = v;
      prop[3 * dim + i] = g;
      prop[4 * dim + i] = mg;
    }
    if (a.is_first) {
      first[i] = q;
      first[dim + i] = p;
      first[2 * dim + i] = v;
      first[3 * dim + i] = g;
      first[4 * dim + i] = mg;
    }
    if (a.is_even) {
      ck[i] = p;
      ck[dim + i] = v;
      ck[2 * dim + i] = r;
    }
    if (track && bad) {
      a.s_div_edge[row + i] = q_old;
      a.s_div_leaf[row + i] = q;
    }
    cq[i] = q;
    cp[i] = p;
    cv[i] = v;
    cg[i] = g;
    cmg[i] = mg;
  }

  // odd leaves: the U-turn checks of every sub-tree ending here, from the
  // committed p_n, v_n and rho (each element written above by this thread)
  bool turned = false;
  if (!a.is_even) {
    for (int k = a.lo; k <= a.hi; ++k) {
      const T* rk = a.ckpts + (c * a.n_rows + k) * 3 * dim;
      const T* vk = rk + dim;
      const T* rhok = vk + dim;
      T left = T(0), right = T(0);
      for (int64_t i = tid; i < dim; i += kThreads) {
        const T rc = O::sub(O::add(O::sub(rho[i], rhok[i]), rk[i]),
                            O::mul(T(0.5), O::add(rk[i], cp[i])));
        left = O::add(left, O::mul(vk[i], rc));
        right = O::add(right, O::mul(rc, cv[i]));
      }
      block_sum2(left, right, smem);
      turned = turned || left <= T(0) || right <= T(0);
    }
  }

  __syncthreads();  // every thread has read the chain's sums before they change
  if (tid == 0) {
    if (take) a.s_logp_prop[c] = logp;
    a.s_lsw[c] = lsw;
    a.s_sum_accept[c] = O::add(a.s_sum_accept[c], accept);
    a.s_n_leaves[c] = O::add(a.s_n_leaves[c], T(1));
    if (bad) a.s_div[c] = true;
    if (!a.is_even) a.s_turn[c] = turned;
    a.alive[c] = !(bad || turned);
  }
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
  a.logp_n = static_cast<const T*>(p[2]);
  a.g_n = static_cast<const T*>(p[3]);
  a.mg_n = static_cast<const T*>(p[4]);
  a.inv_mass = static_cast<const T*>(p[5]);
  a.half = static_cast<const T*>(p[6]);
  a.h0 = static_cast<const T*>(p[7]);
  a.u = static_cast<const T*>(p[8]);
  a.s_prop = static_cast<T*>(p[9]);
  a.s_logp_prop = static_cast<T*>(p[10]);
  a.s_rho = static_cast<T*>(p[11]);
  a.first = static_cast<T*>(p[12]);
  a.ckpts = static_cast<T*>(p[13]);
  a.s_lsw = static_cast<T*>(p[14]);
  a.s_sum_accept = static_cast<T*>(p[15]);
  a.s_n_leaves = static_cast<T*>(p[16]);
  a.s_div = static_cast<bool*>(p[17]);
  a.s_turn = static_cast<bool*>(p[18]);
  a.alive = static_cast<bool*>(p[19]);
  a.s_div_edge = static_cast<T*>(p[20]);
  a.s_div_leaf = static_cast<T*>(p[21]);
  a.n_chains = int(n[0]);
  a.dim = int(n[1]);
  a.n_rows = int(n[2]);
  a.inv_mass_stride = int(n[3]);
  a.j = int(n[4]);
  a.is_first = a.j == 0;
  a.is_even = a.j % 2 == 0;
  a.lo = int(n[5]);
  a.hi = int(n[6]);
  a.max_delta_energy = T(max_delta_energy);
  // exactly one of mg_n and inv_mass; the rows in range; the interface's counts
  const bool diag = a.inv_mass != nullptr;
  if (diag == (a.mg_n != nullptr) || a.hi < 0 || a.hi >= a.n_rows || a.lo < 0 ||
      (!a.is_even && a.lo > a.hi) || int(n[7]) != kNumPointers || int(n[8]) != kNumInts) {
    return cudaErrorInvalidValue;
  }
  if (a.n_chains == 0) return 0;
  nuts_leaf_commit_kernel<T><<<unsigned(a.n_chains), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(a);
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
