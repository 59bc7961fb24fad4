// The dense metric's product M^-1 g of the NUTS leaf (sm_90a):
//
//   mg[c, i] = sum_k minv[i, k] g[c, k],   minv (dim, dim), g and mg (C, dim)
//
// for a batch of C chains sharing one dense inverse mass, stored in float32
// or float64; the rows of minv (p @ minv.T), which is symmetric only up to
// rounding. Replaces no Pallas kernel: it is the product of the JAX
// package's _minv_mv_b (inference/nuts_batched.py:63, jnp.matmul left to
// XLA) inside _leapfrog_b, which the port ran as torch.matmul (cuBLAS). Its
// plain version is ops/minv_mv.py's minv_mv_torch, p @ minv.T. The whitened
// value-and-grad's two GEMMs (zeta W^T and g W) are the same product on W
// and on W^T.
//
// Bound: operations. 2 C dim^2 flop against (dim^2 + 2 C dim) elements: at
// [slice] (C, dim) = (128, 799) float32, 163 Mflop, 2.4 us at the FP32 peak
// of 67 TFLOP/s, against 3.4 MB, 1.0 us at 3.35 TB/s.
//
// Arithmetic: float64 on the FP64 tensor cores (DMMA, sm_90's mma.sync
// m16n8k8; a peak of 67 TFLOP/s on the H100), whatever the storage type:
// the products of float32 inputs are exact in float64 and the sums carry
// ~1e-16 relative error, so a float32 output is the float64 sum rounded
// once, within half an ulp, which no float32 GEMM's output beats. No TF32.
//
// The prepared operand. minv changes once a transition at most (the NUTS
// tree rewrites its copy of the metric then) and is read by hundreds of
// products, so minv_mv_prepare_<t> writes it once into the layout the
// product reads: float64, rows and k padded with zeros to whole 32 x 32
// blocks, each block (row tile rt, k step ks) 8 KB contiguous and in DMMA
// fragment order,
//
//   prep[rt][ks][kk][j][lane][e] = minv[32 rt + 8 j + lane / 4][32 ks + 8 kk + lane % 4 + 4 e]
//
// (kk, j < 4, lane < 32, e < 2: the B fragment of rows 8 j.. and k 8 kk..,
// one 16-byte load a lane). So a block copies a step of minv with one bulk
// copy of the Tensor Memory Accelerator and converts nothing of it (the
// plain version, ops/minv_mv.py prepare_torch, is that permutation).
//
// Design. The (C x dim) output is cut into tiles of kRows = 32 rows i by TC
// chains (TC = 128, 64, 32 or 16, the least that holds C; float64 storage at
// most 64), and the sum over k into S contiguous ranges of whole kStep-wide
// steps, S and the steps a range from dim alone (split below: S = 4 ranges
// of 7 steps at dim 799, so [slice] runs one chain tile, 25 x 4 = 100
// blocks, and minv crosses from L2 to the SMs once a launch). The S blocks
// of a row tile form a thread-block cluster. A block walks its range through
// a ring of kStages stages of minv, each under an mbarrier that thread 0
// arms with the step's bytes as it issues the bulk copy; all of a range's
// steps up to kStages are in flight at once, and a stage is refilled (after
// a block barrier) only when a range has more steps than stages. A warp owns
// 16 chains x 8 NJ rows (NJ = 4 from 32 chains a tile): its lanes load their
// A fragments' g values (float32 or float64, converted to float64 as they
// are used) straight from global memory a step ahead, so g, whose rows of
// 799 floats start at no common 16-byte boundary, is never staged; per eight
// k one A fragment and NJ prepared B fragments feed NJ DMMAs.
//
// Reduction: each block pushes its float64 partials over distributed shared
// memory into the block that owns their chains (rank o owns the tile's
// chains c with o = c S / TC), in a slot of its own rank; after one cluster
// barrier each block adds its slots in rank order, rounds once to T and
// writes. (An arrive at the kernel's start, waited on after the k loop,
// makes sure every block of the cluster has started before it is written.)
//
// Fixed summation order: an output's range sums its k through the DMMAs in
// ascending groups of eight, and the S ranges' sums are added in rank
// order, all of it fixed by dim alone, so a chain's bits do not depend on
// C, the chain tile, or which chains share its launch.
//
// Measured on the H100 (PERF.md, perf/product_timing.py): at [slice]
// 0.81x cuBLAS's float32 GEMM (the first design, perf/baselines/
// minv_mv_pr13.cu, 1.24x); staging g in shared memory with cp.async, as
// that design did, took 1.1-1.3x as long at 128 chains.
//
// The launches (cudaLaunchKernelEx with the cluster dimension) go on the
// caller's stream, allocate nothing and do not synchronise, so CUDA graphs
// capture them, a WHILE node's body among them.
//
// Stage stamps (utils/trace.py): minv_mv_traced_<t> takes the tracer's
// stamp buffer, the stage its stamp closes and the stage it opens (the
// value-and-grad's, at its opening GEMM, or the metric's product), and runs
// the kernel's traced instantiation: the last thread of block (0, 0, 0)
// stamps on entry (thread 0 fences the mbarriers' initialisation at once,
// which would wait for the stamp's atomics). A stamp changes nothing the
// kernel computes; minv_mv_<t> runs the untraced kernel, which holds none.
//
// C interface (ctypes), each in _f32 and _f64, returning a cudaError_t:
//   minv_mv_<t>(prepared, g, mg, n_chains, dim, stream)
//   minv_mv_traced_<t>(prepared, g, mg, n_chains, dim, trace, prev, stage, stream)
//   minv_mv_prepare_<t>(minv, prepared, dim, row_stride, col_stride, stream)
// with prepared of minv_mv_prepared_doubles(dim) doubles.
//
// MINV_MV_PROBE (a measurement build, perf/product_timing.py --probes; its
// outputs are wrong): 1 skips the DMMAs, 2 the bulk copies, 3 the cluster's
// reduction (each block sums its own slots only), 4 the body, 5 the g loads
// (constant A fragments), 6 the conversions to float64 (bits moved as they
// are).

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef MINV_MV_PROBE
#define MINV_MV_PROBE 0
#endif

namespace {

constexpr int kRows = 32;          // output rows i a block: the prepared operand's row tile
constexpr int kStep = 32;          // k a stage: the prepared operand's k step
constexpr int kStepsPerRange = 7;  // the k range's steps S is chosen for
constexpr int kMaxSplit = 4;       // S at most: longer ranges, not more of them
constexpr int kStages = 7;         // the ring's stages
constexpr int kTraceStages = 6;    // the tracer's stages (utils/trace.py STAGES)

// The tracer's stamp (csrc/nuts_leaf.cu has the same): buf = [the last
// stamp's ns, the stage it opened, the first stamp's ns, ns by stage,
// entries by stage]; it closes stage prev and opens stage with atomics that
// return nothing the thread waits on.
__device__ __forceinline__ void trace_stamp(int64_t* buf, int prev, int stage) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  unsigned long long* b = reinterpret_cast<unsigned long long*>(buf);
  atomicAdd(b + 3 + prev, now);
  atomicAdd(b + 3 + stage, 0ull - now);
  atomicAdd(b + 3 + kTraceStages + prev, 1ull);
  b[0] = now;
  b[1] = static_cast<unsigned long long>(stage);
}

constexpr int kBlockDoubles = kRows * kStep;  // a prepared (row tile, step) block: 8 KB
constexpr int kBarBytes = 128;     // the mbarriers' room at the start of shared memory

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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool bar_try_wait(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of `parity` to complete; a phase that never does (a
// copy that never lands) fails the launch instead of hanging the card.
__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  for (unsigned spins = 0; !bar_try_wait(bar, parity); ++spins)
    if (spins == (1u << 22)) __trap();
}

// Stage one prepared block: arm `bar` with its bytes and issue the Tensor
// Memory Accelerator's bulk copy, whose completion the barrier counts.
__device__ __forceinline__ void stage_block(unsigned dst, const double* src, unsigned bar) {
  constexpr unsigned kBytes = 8 * kBlockDoubles;
#if MINV_MV_PROBE == 2
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
  (void)dst, (void)src;
#else
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(kBytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(kBytes), "r"(bar)
      : "memory");
#endif
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Two doubles to another block's shared memory (a shared::cta address of
// this block's layout, mapped to rank's).
__device__ __forceinline__ void store_remote(unsigned local, int rank, double x, double y) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("st.shared::cluster.v2.f64 [%0], {%1, %2};\n" ::"r"(remote), "d"(x), "d"(y)
               : "memory");
}

// A g value in float64, exactly.
__device__ __forceinline__ double widen(double x) { return x; }
__device__ __forceinline__ double widen(float x) {
#if MINV_MV_PROBE == 6
  return __hiloint2double(__float_as_int(x), 0);  // no conversion: wrong values
#else
  return double(x);
#endif
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

template <int TC>
struct Tile {
  static constexpr int kChainWarps = TC / 16;  // a warp's 16 chains (one DMMA's m)
  // a warp's rows: all 32 of the tile, but for 16 chains (one warp) 8
  static constexpr int kRowWarps = TC == 16 ? 4 : 1;
  static constexpr int kWarps = kChainWarps * kRowWarps;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kNJ = kRows / 8 / kRowWarps;  // a warp's row groups of eight
  static constexpr int kStageBytes = 8 * kBlockDoubles;
  // S slots of ceil(TC / S) chains x kRows float64 partials
  static __host__ __device__ constexpr int recv_bytes(int s) {
    return s > 1 ? 8 * s * ((TC + s - 1) / s) * kRows : 0;
  }
  static __host__ __device__ constexpr int shared_bytes(int s) {
    return kBarBytes + kStages * kStageBytes + recv_bytes(s);
  }
  static __host__ __device__ constexpr int max_shared_bytes() {
    int m = 0;
    for (int s = 1; s <= kMaxSplit; ++s) m = shared_bytes(s) > m ? shared_bytes(s) : m;
    return m;
  }
  static_assert(kStages * 8 <= kBarBytes, "the mbarriers' room");
};

// grid (S, row tiles, chain tiles), clusters of (S, 1, 1).
template <typename T, int TC, bool kTraced>
__global__ void __launch_bounds__(Tile<TC>::kThreads)
    minv_mv_kernel(const double* __restrict__ prep, const T* __restrict__ g, T* __restrict__ mg,
                   int n_chains, int dim, int64_t* trace, int prev, int stage) {
  using L = Tile<TC>;
  extern __shared__ __align__(128) unsigned char smem[];
  if (kTraced && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&
      threadIdx.x == L::kThreads - 1) {
    trace_stamp(trace, prev, stage);
  }
#if MINV_MV_PROBE == 4
  return;
#endif
  const Split sp = split_for(dim);
  const int S = sp.ranges;
  const int rank = blockIdx.x;  // the cluster's rank: clusters span gridDim.x
  const int rt = blockIdx.y, c0 = blockIdx.z * TC;
  const int steps = (dim + kStep - 1) / kStep;  // also the prepared operand's k steps
  const int s_begin = rank * sp.steps_per_range;
  const int n_steps = max(min(steps, s_begin + sp.steps_per_range) - s_begin, 0);
  const int k_begin = s_begin * kStep, k_end = min(dim, (s_begin + n_steps) * kStep);
  const unsigned bars = smem_u32(smem);
  const unsigned stages = bars + kBarBytes;
  const double* blocks = prep + (int64_t(rt) * steps + s_begin) * kBlockDoubles;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) bar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int s = 0; s < min(n_steps, kStages); ++s)
      stage_block(stages + s * L::kStageBytes, blocks + s * kBlockDoubles, bars + 8 * s);
  }
  __syncthreads();
  if (S > 1) cluster_arrive_relaxed();  // started; waited on before the pushes

  // The warp's outputs: chains wc + group (+ 8), rows 8 j + 2 quad (+ 1)
  // for its NJ row groups j from wj; the lane's A values of a step, k = k0
  // + 4 i + quad for i < 8, from its two chains' rows, loaded a step ahead.
  const int group = lane >> 2, quad = lane & 3;
  const int wc = (warp % L::kChainWarps) * 16, wj = (warp / L::kChainWarps) * L::kNJ;
  const T* grow[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = c0 + wc + 8 * h + group;
    live[h] = row < n_chains;
    grow[h] = g + int64_t(live[h] ? row : 0) * dim + quad;
  }
  T next[2][8];
  auto fetch = [&](int s) {
    const int k0 = k_begin + s * kStep;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        next[h][i] = live[h] && k0 + 4 * i + quad < k_end ? __ldg(grow[h] + k0 + 4 * i) : T(0);
  };
  if (n_steps > 0) fetch(0);

  double acc[L::kNJ][2][2];
#pragma unroll
  for (int j = 0; j < L::kNJ; ++j) acc[j][0][0] = acc[j][0][1] = acc[j][1][0] = acc[j][1][1] = 0.0;

  for (int s = 0; s < n_steps; ++s) {
    T cur[2][8];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 8; ++i) cur[h][i] = next[h][i];
    if (s + 1 < n_steps) fetch(s + 1);
    const int slot = s % kStages;
    bar_wait(bars + 8 * slot, unsigned(s / kStages) & 1u);
    const double2* bq = reinterpret_cast<const double2*>(smem + kBarBytes + slot * L::kStageBytes);
#pragma unroll
    for (int kk = 0; kk < kStep / 8; ++kk) {
#if MINV_MV_PROBE == 5
      const double a[4] = {double(lane), double(kk), double(lane + 4), double(s)};  // no loads
#else
      const double a[4] = {widen(cur[0][2 * kk]), widen(cur[1][2 * kk]),
                           widen(cur[0][2 * kk + 1]), widen(cur[1][2 * kk + 1])};
#endif
#pragma unroll
      for (int j = 0; j < L::kNJ; ++j) {
        const double2 b = bq[(kk * 4 + wj + j) * 32 + lane];
#if MINV_MV_PROBE == 1
        acc[j][0][0] += a[0] * b.x + a[3] * b.y;  // two FMAs for the DMMA's 1024
#else
        dmma(acc[j], a, b.x, b.y);
#endif
      }
    }
    if (s + kStages < n_steps) {
      __syncthreads();  // every warp is done with the slot
      if (tid == 0)
        stage_block(stages + slot * L::kStageBytes, blocks + (s + kStages) * kBlockDoubles,
                    bars + 8 * slot);
    }
  }

  const int i0 = rt * kRows;
  if (S == 1) {
#pragma unroll
    for (int j = 0; j < L::kNJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + wc + 8 * h + group;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int i = i0 + 8 * (wj + j) + 2 * quad + q;
          if (c < n_chains && i < dim) mg[int64_t(c) * dim + i] = T(acc[j][h][q]);
        }
      }
    return;
  }

  // Push the partials to their owners' slot `rank`: owner o holds the
  // tile's chains lo(o) .. lo(o + 1) - 1, lo(o) = ceil(o TC / S).
  const int slice = (TC + S - 1) / S;
  const unsigned recv = stages + kStages * L::kStageBytes;
  cluster_wait();  // every block of the cluster has started
#if MINV_MV_PROBE != 3
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = wc + 8 * h + group;
    const int o = c * S / TC, lo = (o * TC + S - 1) / S;
#pragma unroll
    for (int j = 0; j < L::kNJ; ++j) {
      const int i = 8 * (wj + j) + 2 * quad;
      store_remote(recv + 8 * ((rank * slice + c - lo) * kRows + i), o, acc[j][h][0],
                   acc[j][h][1]);
    }
  }
  cluster_arrive();
  cluster_wait();  // every partial has landed in its owner
#endif
  const double* mine =
      reinterpret_cast<const double*>(smem + kBarBytes + kStages * L::kStageBytes);
  const int lo = (rank * TC + S - 1) / S, hi = ((rank + 1) * TC + S - 1) / S;
  for (int e = tid; e < (hi - lo) * kRows; e += L::kThreads) {
    double v = mine[e];
#if MINV_MV_PROBE != 3
    for (int r = 1; r < S; ++r) v = __dadd_rn(v, mine[r * slice * kRows + e]);
#endif
    const int c = c0 + lo + e / kRows, i = i0 + e % kRows;
    if (c < n_chains && i < dim) mg[int64_t(c) * dim + i] = T(v);
  }
}

// The prepared operand (see the top), one lane's pair of doubles a thread.
template <typename T>
__global__ void minv_mv_prepare_kernel(const T* __restrict__ minv, double2* __restrict__ prep,
                                       int dim, int64_t row_stride, int64_t col_stride,
                                       int64_t pairs) {
  const int steps = (dim + kStep - 1) / kStep;
  for (int64_t p = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; p < pairs;
       p += int64_t(gridDim.x) * blockDim.x) {
    const int lane = int(p & 31), j = int((p >> 5) & 3), kk = int((p >> 7) & 3);
    const int64_t block = p >> 9;
    const int ks = int(block % steps), rt = int(block / steps);
    const int row = rt * kRows + 8 * j + (lane >> 2);
    const int col = ks * kStep + 8 * kk + (lane & 3);
    double2 v;
    v.x = row < dim && col < dim ? double(minv[row * row_stride + col * col_stride]) : 0.0;
    v.y = row < dim && col + 4 < dim ? double(minv[row * row_stride + (col + 4) * col_stride])
                                     : 0.0;
    prep[p] = v;
  }
}

template <typename T, int TC>
cudaLaunchConfig_t config_for(int n_chains, int dim, cudaStream_t stream,
                              cudaLaunchAttribute* attr) {
  using L = Tile<TC>;
  const Split sp = split_for(dim);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(unsigned(sp.ranges), unsigned((dim + kRows - 1) / kRows),
                        unsigned((n_chains + TC - 1) / TC));
  config.blockDim = dim3(unsigned(L::kThreads), 1, 1);
  config.dynamicSmemBytes = L::shared_bytes(sp.ranges);
  config.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(sp.ranges);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

template <typename T, int TC, bool kTraced = false>
cudaError_t shared_attr() {
  static const cudaError_t err = cudaFuncSetAttribute(
      minv_mv_kernel<T, TC, kTraced>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile<TC>::max_shared_bytes());
  return err;
}

template <typename T, int TC, bool kTraced>
int launch_traced(const double* prep, const T* g, T* mg, int n_chains, int dim,
                  int64_t* trace, int prev, int stage, cudaStream_t stream) {
  const cudaError_t attr = shared_attr<T, TC, kTraced>();
  if (attr != cudaSuccess) return attr;
  cudaLaunchAttribute cluster[1];
  const cudaLaunchConfig_t config = config_for<T, TC>(n_chains, dim, stream, cluster);
  const cudaError_t err = cudaLaunchKernelEx(&config, minv_mv_kernel<T, TC, kTraced>, prep, g,
                                             mg, n_chains, dim, trace, prev, stage);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int TC>
int launch_tile(const double* prep, const T* g, T* mg, int n_chains, int dim,
                int64_t* trace, int prev, int stage, cudaStream_t stream) {
  return trace ? launch_traced<T, TC, true>(prep, g, mg, n_chains, dim, trace, prev, stage, stream)
               : launch_traced<T, TC, false>(prep, g, mg, n_chains, dim, trace, prev, stage,
                                             stream);
}

// The clusters of a launch at (n_chains, dim) that the card runs at once
// (cudaOccupancyMaxActiveClusters), or a negative CUDA error.
template <typename T, int TC>
int clusters_of(int n_chains, int dim) {
  const cudaError_t attr = shared_attr<T, TC>();
  if (attr != cudaSuccess) return -int(attr);
  cudaLaunchAttribute cluster[1];
  const cudaLaunchConfig_t config = config_for<T, TC>(n_chains, dim, 0, cluster);
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&n, minv_mv_kernel<T, TC, false>, &config);
  return err != cudaSuccess ? -int(err) : n;
}

// The chain tile of a launch: one tile up to 128 chains (64 for float64),
// the least that holds C.
template <typename T>
int chain_tile(int n_chains) {
  if (n_chains > 64 && sizeof(T) == 4) return 128;
  if (n_chains > 32) return 64;
  if (n_chains > 16) return 32;
  return 16;
}

template <typename T>
int launch(const void* prep, const void* g, void* mg, int n_chains, int dim, void* trace,
           int prev, int stage, void* stream) {
  if (n_chains < 0 || dim < 0 || n_chains >= (1 << 16) * 16) return cudaErrorInvalidValue;
  if (trace && (stage < 0 || stage >= kTraceStages || prev < 0 || prev >= kTraceStages)) {
    return cudaErrorInvalidValue;
  }
  if (n_chains == 0 || dim == 0) return 0;
  const double* p = static_cast<const double*>(prep);
  const T* x = static_cast<const T*>(g);
  T* y = static_cast<T*>(mg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t* t = static_cast<int64_t*>(trace);
  switch (chain_tile<T>(n_chains)) {
    case 128: return launch_tile<T, 128>(p, x, y, n_chains, dim, t, prev, stage, s);
    case 64: return launch_tile<T, 64>(p, x, y, n_chains, dim, t, prev, stage, s);
    case 32: return launch_tile<T, 32>(p, x, y, n_chains, dim, t, prev, stage, s);
    default: return launch_tile<T, 16>(p, x, y, n_chains, dim, t, prev, stage, s);
  }
}

int64_t prepared_doubles(int dim) {
  const int64_t steps = (dim + kStep - 1) / kStep;
  return steps * steps * kBlockDoubles;
}

template <typename T>
int prepare(const void* minv, void* prep, int dim, int64_t row_stride, int64_t col_stride,
            void* stream) {
  if (dim < 0) return cudaErrorInvalidValue;
  if (dim == 0) return 0;
  const int64_t pairs = prepared_doubles(dim) / 2;
  const int threads = 256;
  const int64_t blocks = (pairs + threads - 1) / threads;
  minv_mv_prepare_kernel<T><<<unsigned(blocks < 65535 ? blocks : 65535), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(minv), static_cast<double2*>(prep), dim, row_stride, col_stride,
      pairs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int minv_mv_f32(const void* prepared, const void* g, void* mg, int n_chains, int dim,
                void* stream) {
  return launch<float>(prepared, g, mg, n_chains, dim, nullptr, 0, 0, stream);
}

int minv_mv_f64(const void* prepared, const void* g, void* mg, int n_chains, int dim,
                void* stream) {
  return launch<double>(prepared, g, mg, n_chains, dim, nullptr, 0, 0, stream);
}

int minv_mv_traced_f32(const void* prepared, const void* g, void* mg, int n_chains, int dim,
                       void* trace, int prev, int stage, void* stream) {
  return launch<float>(prepared, g, mg, n_chains, dim, trace, prev, stage, stream);
}

int minv_mv_traced_f64(const void* prepared, const void* g, void* mg, int n_chains, int dim,
                       void* trace, int prev, int stage, void* stream) {
  return launch<double>(prepared, g, mg, n_chains, dim, trace, prev, stage, stream);
}

int minv_mv_prepare_f32(const void* minv, void* prepared, int dim, int64_t row_stride,
                        int64_t col_stride, void* stream) {
  return prepare<float>(minv, prepared, dim, row_stride, col_stride, stream);
}

int minv_mv_prepare_f64(const void* minv, void* prepared, int dim, int64_t row_stride,
                        int64_t col_stride, void* stream) {
  return prepare<double>(minv, prepared, dim, row_stride, col_stride, stream);
}

int64_t minv_mv_prepared_doubles(int dim) { return prepared_doubles(dim); }

// The chain tile of a float32 launch at n_chains, and the clusters of such
// a launch at (n_chains, dim) the card runs at once.
int minv_mv_chain_tile_f32(int n_chains) { return chain_tile<float>(n_chains); }

int minv_mv_max_clusters_f32(int n_chains, int dim) {
  switch (chain_tile<float>(n_chains)) {
    case 128: return clusters_of<float, 128>(n_chains, dim);
    case 64: return clusters_of<float, 64>(n_chains, dim);
    case 32: return clusters_of<float, 32>(n_chains, dim);
    default: return clusters_of<float, 16>(n_chains, dim);
  }
}

}  // extern "C"
