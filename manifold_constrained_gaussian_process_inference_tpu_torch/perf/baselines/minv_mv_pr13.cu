// The dense metric's product kernel in its first design: minv and
// g staged by 16-byte cp.async, 64-chain tiles, five k ranges at dim 799.
// Not built by the package: perf/product_timing.py and chip_smoke.py's
// [leaf] build it beside csrc/minv_mv.cu and time both in the same run.
// Its C interface takes minv itself, not a prepared operand.
//
// The dense metric's product M^-1 g of the NUTS leaf (sm_90a):
//
//   mg[c, i] = sum_k minv[i, k] g[c, k],   minv (dim, dim), g and mg (C, dim)
//
// for a batch of C chains sharing one dense inverse mass, stored in float32
// or float64; the rows of minv (p @ minv.T), which is symmetric only up to
// rounding. Replaces no Pallas kernel: it is the product of the JAX
// package's _minv_mv_b (inference/nuts_batched.py:63, jnp.matmul left to
// XLA) inside _leapfrog_b, which the port ran as torch.matmul (cuBLAS). Its
// plain version is ops/minv_mv.py's minv_mv_torch, p @ minv.T.
//
// Bound: operations. 2 C dim^2 flop against (dim^2 + 2 C dim) elements: at
// [slice] (C, dim) = (128, 799) float32, 163 Mflop, 2.4 us at the FP32 peak
// of 67 TFLOP/s, against 3.4 MB, 1.0 us at 3.35 TB/s. A cuBLAS GEMM of this
// shape puts a 128-wide output tile on only a handful of the 132 SMs.
//
// Arithmetic: float64 on the FP64 tensor cores (DMMA, sm_90's mma.sync
// m16n8k8; a peak of 67 TFLOP/s on the H100, the FP32 CUDA cores'), whatever
// the storage type:
// the products of float32 inputs are exact in float64 and the sums carry
// ~1e-16 relative error, so a float32 output is the float64 sum rounded
// once, within half an ulp, which no float32 GEMM's output beats (a first
// design summing in float32 on CUDA cores was further from the float64
// product than cuBLAS at three chains, and 1.6x cuBLAS's time at [slice]).
// No TF32 anywhere.
//
// Design. The (C x dim) output is cut into tiles of kRows rows i by TC
// chains (TC = 64, 32 or 16 by C; float64 storage at most 32), and the sum
// over k into S contiguous ranges of whole kStep-wide steps, S and the steps
// a range from dim alone (split below: S = 5 at dim 799, so [slice] runs
// 5 x 13 x 2 = 130 blocks). The S blocks of one tile form a thread-block
// cluster: each sums its k range into float64 partials in its shared
// memory, and after a cluster barrier every block adds the S partials of its
// slice of the tile in rank order, reading the others' through distributed
// shared memory, and writes it. A block stages its rows of minv and of g
// for up to kMaxSteps steps at once (a window), every step's 16-byte
// cp.async copies in flight together, one commit group a step, so a step
// waits for its own copies only: a row of 799 floats starts at no common
// alignment, so a staged row starts at the 16-byte boundary at or before its
// first k and the fragment loads skip its shift. A warp owns 16 chains x 32
// rows: per 8 k, one A fragment (g, 16 chains x 8 k) and four B fragments
// (minv's rows, 8 x 8), converted to float64 as they are loaded, feed 4
// DMMAs into 16 float64 accumulators a lane; below 64 chains a tile two
// warps share a warp tile, each on every other group of eight k.
//
// Fixed summation order: an output's range sums its k through the DMMAs in
// ascending groups of eight (with two warps a tile: the odd groups' sum
// added to the even groups'), and the S ranges' sums are added in rank
// order, all of it fixed by dim alone, so a chain's bits do not depend on
// C, the chain tile, or which chains share its launch.
//
// Measured on the H100 (PERF.md, perf/product_timing.py): 1.26x cuBLAS's
// float32 GEMM at [slice], as fast at 32 and 64 chains; m16n8k8 takes
// 0.77x the time of the same kernel on m8n8k4 DMMAs at [slice], m16n8k16
// 1.07x; float32 error a quarter of cuBLAS's against float64.
//
// The launch (cudaLaunchKernelEx with the cluster dimension) goes on the
// caller's stream, allocates nothing and does not synchronise, so CUDA
// graphs capture it, a WHILE node's body among them.
//
// C interface (ctypes), each in _f32 and _f64, returning a cudaError_t:
//   minv_mv_<t>(minv, g, mg, n_chains, dim, stream)
//
// MINV_MV_PROBE (a measurement build, perf/product_timing.py --probes; its
// outputs are wrong): 1 skips the DMMAs, 2 the copies, 3 the cluster's
// reduction (each block writes its own slice of its partials), 4 the body.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef MINV_MV_PROBE
#define MINV_MV_PROBE 0
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 64;          // output rows i a block
constexpr int kStep = 32;          // k a copy group (a commit group of cp.async)
constexpr int kStepsPerRange = 5;  // the k range's steps S is chosen for
constexpr int kMaxSplit = 8;       // S, a portable cluster
constexpr int kMaxSteps = 5;       // steps staged at once (a window; a range may have more)
constexpr int kWarpChains = 16, kWarpRows = 32;  // a warp's outputs
constexpr int kPartialLd = kRows + 1;            // the float64 partials' row stride

// S and the steps of each k range, from dim alone (ops/minv_mv.py split).
struct Split {
  int ranges, steps_per_range;
};

__host__ __device__ inline Split split_for(int dim) {
  const int steps = (dim + kStep - 1) / kStep;
  int ranges = (steps + kStepsPerRange - 1) / kStepsPerRange;
  ranges = ranges < 1 ? 1 : (ranges > kMaxSplit ? kMaxSplit : ranges);
  return {ranges, (steps + ranges - 1) / ranges};
}

// One 16-byte asynchronous copy into shared memory of its first `bytes`,
// zero-filling the rest (no global read past them).
__device__ __forceinline__ void copy16_async(void* dst, const void* src, int bytes) {
#if MINV_MV_PROBE == 2
  return;
#endif
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n (< kMaxSteps) of this thread's newest copy groups
// are in flight (any other n: until none is).
__device__ __forceinline__ void wait_copies(int n) {
  static_assert(kMaxSteps <= 5, "wait_copies covers windows of up to 5 steps");
  switch (n) {
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
  }
}

// d += a b over one 16 x 8 x 8 tile in float64 (sm_90's DMMA shape). With
// g = lane / 4 and t = lane % 4, a lane holds a = A[g][t], A[g + 8][t],
// A[g][t + 4], A[g + 8][t + 4] (16 x 8, row-major), b = B[t][g], B[t + 4][g]
// (8 x 8, column-major) and d = D[g][2 t + {0, 1}], D[g + 8][2 t + {0, 1}].
__device__ __forceinline__ void dmma(double (&d)[2][2], const double (&a)[4], double b0,
                                     double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0][0]), "+d"(d[0][1]), "+d"(d[1][0]), "+d"(d[1][1])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

template <typename T, int TC>
struct Tile {
  // Below 64 chains a tile, kSplitK warps a warp tile, each on every
  // kSplitK-th group of eight k of every step: more warps in flight for the
  // DMMAs' latency (at 64 they would leave too few clusters resident).
  static constexpr int kSplitK = TC == 64 ? 1 : 2;
  static constexpr int kWarps = kSplitK * (TC / kWarpChains) * (kRows / kWarpRows);
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kStaged = kRows + TC;        // rows staged: minv's, then g's
  static constexpr int kVec = 16 / int(sizeof(T));  // elements a 16-byte copy
  // A staged row holds a block's whole k range from the 16-byte boundary at
  // or before its first k (its shift), in kVec-element chunks.
  static __host__ __device__ int chunks(int steps) { return (steps * kStep + 2 * kVec - 2) / kVec; }
  static __host__ __device__ int row_ld(int steps) {
    return chunks(steps) * kVec + (kVec == 4 ? 4 : 2);  // padded: rows start on other banks
  }
  static __host__ __device__ size_t shared_bytes(int steps) {  // steps a window
    const size_t staged = sizeof(T) * size_t(kStaged) * row_ld(steps);
    const size_t partial = sizeof(double) * TC * kPartialLd;
    return staged > partial ? staged : partial;
  }
};

// grid (S, row tiles, chain tiles), clusters of (S, 1, 1).
template <typename T, int TC>
__global__ void __launch_bounds__(Tile<T, TC>::kThreads)
    minv_mv_kernel(const T* __restrict__ minv, const T* __restrict__ g, T* __restrict__ mg,
                   int n_chains, int dim) {
  using L = Tile<T, TC>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* staged = reinterpret_cast<T*>(smem_raw);
  const Split sp = split_for(dim);
  const int rank = blockIdx.x;  // the cluster's rank: clusters span gridDim.x
  const int i0 = blockIdx.y * kRows, c0 = blockIdx.z * TC;
  const int steps = (dim + kStep - 1) / kStep;
  const int s_begin = rank * sp.steps_per_range;
  const int s_end = min(steps, s_begin + sp.steps_per_range);
  const int n_steps = max(s_end - s_begin, 0);
  const int k_begin = s_begin * kStep, k_end = min(dim, s_end * kStep);
  // the steps staged at once (a window), and the staged rows' stride
  const int ld = L::row_ld(min(sp.steps_per_range, kMaxSteps));
#if MINV_MV_PROBE == 4
  return;
#endif

  const int lane = threadIdx.x & 31;
  const int part = (threadIdx.x >> 5) / (L::kWarps / L::kSplitK);  // the warp's part of the k
  const int warp = (threadIdx.x >> 5) % (L::kWarps / L::kSplitK);  // its tile
  const int wc = (warp % (TC / kWarpChains)) * kWarpChains;  // the warp's first chain
  const int wr = (warp / (TC / kWarpChains)) * kWarpRows;    // and first row
  const int group = lane >> 2, quad = lane & 3;
  // The lane's fragment rows: g's chains wc + 8 h + group and minv's rows
  // wr + 8 j + group, each at its first k after the row's shift (the offset
  // of k_begin from the 16-byte boundary at or before it: the same for
  // every window, whose starts are kStep apart).
  const T* fa[2];
  const T* fb[4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = kRows + wc + 8 * h + group;
    fa[h] = staged + r * ld + int((int64_t(c0 + r - kRows) * dim + k_begin) % L::kVec) + quad +
            8 * part;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = wr + 8 * j + group;
    fb[j] = staged + r * ld + int((int64_t(i0 + r) * dim + k_begin) % L::kVec) + quad + 8 * part;
  }

  double acc[4][2][2];  // [row group of 8][chain group of 8][the lane's two columns]
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) acc[j][h][0] = acc[j][h][1] = 0.0;

  const int chunks_per_step = kStep / L::kVec;
  for (int w0 = 0; w0 < n_steps; w0 += kMaxSteps) {
    const int w_steps = min(kMaxSteps, n_steps - w0), k_w = k_begin + w0 * kStep;
    if (w0 > 0) __syncthreads();  // the previous window's reads are done
    // Every step of the window in flight at once, one commit group a step:
    // row r's chunk c (kVec elements from the row's 16-byte boundary at or
    // before k_w) to staged[r][c kVec]; zero past k_end, dim or the chains.
    // Step s reads chunks s cps .. s cps + cps (cps chunks a step, one more
    // for the shift), all in groups 0..s.
    for (int s = 0; s < w_steps; ++s) {
      const int c_lo = s == 0 ? 0 : s * chunks_per_step + 1;
      const int n_chunks = (s + 1) * chunks_per_step + 1 - c_lo;
      for (int e = threadIdx.x; e < L::kStaged * n_chunks; e += L::kThreads) {
        const int r = e / n_chunks, c = c_lo + e % n_chunks;
        const bool of_minv = r < kRows;
        const int row = of_minv ? i0 + r : c0 + r - kRows;
        const bool valid = row < (of_minv ? dim : n_chains);
        const T* base = of_minv ? minv : g;
        const int first = k_w - int((int64_t(row) * dim + k_w) % L::kVec) + c * L::kVec;
        const int n = valid ? max(0, min(L::kVec, k_end - first)) : 0;
        copy16_async(staged + r * ld + c * L::kVec,
                     n > 0 ? base + int64_t(row) * dim + first : base, n * int(sizeof(T)));
      }
      commit_copies();
    }
    for (int s = 0; s < w_steps; ++s) {
      wait_copies(w_steps - 1 - s);
      __syncthreads();  // step s has landed for every thread
      const int k = s * kStep;
#pragma unroll
      for (int kk = 0; kk < kStep; kk += 8 * L::kSplitK) {  // this part's groups of eight k
        const double a[4] = {double(fa[0][k + kk]), double(fa[1][k + kk]),
                             double(fa[0][k + kk + 4]), double(fa[1][k + kk + 4])};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const double b0 = double(fb[j][k + kk]), b1 = double(fb[j][k + kk + 4]);
#if MINV_MV_PROBE == 1
          acc[j][0][0] += a[0] * b0 + a[3] * b1;  // two FMAs for the DMMA's 512
#else
          dmma(acc[j], a, b0, b1);
#endif
        }
      }
    }
  }
  __syncthreads();  // the staged rows' last reads are done: their memory takes the partials

  // this block's partial sums in float64, [chain][row]: the last part's,
  // then each earlier part's plus them
  double* partial = reinterpret_cast<double*>(smem_raw);
  for (int pass = L::kSplitK - 1; pass >= 0; --pass) {
    if (part == pass) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            double& at = partial[(wc + 8 * h + group) * kPartialLd + wr + 8 * j + 2 * quad + q];
            at = pass == L::kSplitK - 1 ? acc[j][h][q] : __dadd_rn(acc[j][h][q], at);
          }
    }
    if (pass) __syncthreads();
  }
  const int S = MINV_MV_PROBE == 3 ? 1 : sp.ranges;
  cg::cluster_group cluster = cg::this_cluster();
  if (S > 1) {
    cluster.sync();  // every block's partials are written
  } else {
    __syncthreads();
  }
  // this block's slice of the tile: the S ranges' partials added in rank
  // order, rounded once to T
  const int total = TC * kRows, per = (total + S - 1) / S;
  const int e_end = min(total, (rank + 1) * per);
  for (int e = rank * per + threadIdx.x; e < e_end; e += L::kThreads) {
    const int c = e / kRows, i = e - c * kRows;
    const int at = c * kPartialLd + i;
    double v = S > 1 ? cluster.map_shared_rank(partial, 0)[at] : partial[at];
    for (int r = 1; r < S; ++r) v = __dadd_rn(v, cluster.map_shared_rank(partial, r)[at]);
    if (c0 + c < n_chains && i0 + i < dim) mg[int64_t(c0 + c) * dim + i0 + i] = T(v);
  }
  if (S > 1) cluster.sync();  // no block leaves while another reads its partials
}

template <typename T, int TC>
cudaLaunchConfig_t config_for(int n_chains, int dim, cudaStream_t stream,
                              cudaLaunchAttribute* attr) {
  using L = Tile<T, TC>;
  const Split sp = split_for(dim);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(unsigned(sp.ranges), unsigned((dim + kRows - 1) / kRows),
                        unsigned((n_chains + TC - 1) / TC));
  config.blockDim = dim3(unsigned(L::kThreads), 1, 1);
  config.dynamicSmemBytes = L::shared_bytes(min(sp.steps_per_range, kMaxSteps));
  config.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(sp.ranges);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

template <typename T, int TC>
int launch_tile(const T* minv, const T* g, T* mg, int n_chains, int dim, cudaStream_t stream) {
  using L = Tile<T, TC>;
  auto kernel = minv_mv_kernel<T, TC>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L::shared_bytes(kMaxSteps)));
  if (attr != cudaSuccess) return attr;
  cudaLaunchAttribute cluster[1];
  const cudaLaunchConfig_t config = config_for<T, TC>(n_chains, dim, stream, cluster);
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, minv, g, mg, n_chains, dim);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The clusters of a launch at (n_chains, dim) that the card runs at once
// (cudaOccupancyMaxActiveClusters), or a negative CUDA error.
template <typename T, int TC>
int clusters_of(int n_chains, int dim) {
  using L = Tile<T, TC>;
  auto kernel = minv_mv_kernel<T, TC>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L::shared_bytes(kMaxSteps)));
  if (attr != cudaSuccess) return -int(attr);
  cudaLaunchAttribute cluster[1];
  const cudaLaunchConfig_t config = config_for<T, TC>(n_chains, dim, 0, cluster);
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, kernel, &config);
  return err != cudaSuccess ? -int(err) : n;
}

template <typename T>
int launch(const void* minv, const void* g, void* mg, int n_chains, int dim, void* stream) {
  if (n_chains < 0 || dim < 0 || n_chains >= (1 << 16) * 16) return cudaErrorInvalidValue;
  if (n_chains == 0 || dim == 0) return 0;
  const T* m = static_cast<const T*>(minv);
  const T* x = static_cast<const T*>(g);
  T* y = static_cast<T*>(mg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // float64's staged rows take twice the bytes: its chain tile stays at 32
  if (n_chains > 32 && sizeof(T) == 4) return launch_tile<T, 64>(m, x, y, n_chains, dim, s);
  if (n_chains > 16) return launch_tile<T, 32>(m, x, y, n_chains, dim, s);
  return launch_tile<T, 16>(m, x, y, n_chains, dim, s);
}

}  // namespace

extern "C" {

int minv_mv_f32(const void* minv, const void* g, void* mg, int n_chains, int dim, void* stream) {
  return launch<float>(minv, g, mg, n_chains, dim, stream);
}

int minv_mv_f64(const void* minv, const void* g, void* mg, int n_chains, int dim, void* stream) {
  return launch<double>(minv, g, mg, n_chains, dim, stream);
}

// The clusters of a float32 launch at (n_chains, dim) the card runs at once.
int minv_mv_max_clusters_f32(int n_chains, int dim) {
  if (n_chains > 32) return clusters_of<float, 64>(n_chains, dim);
  if (n_chains > 16) return clusters_of<float, 32>(n_chains, dim);
  return clusters_of<float, 16>(n_chains, dim);
}

}  // extern "C"
