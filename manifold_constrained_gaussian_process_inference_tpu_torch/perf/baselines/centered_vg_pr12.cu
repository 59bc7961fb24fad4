// The whitened FN value-and-grad's kernel in its second design (the
// cluster of row slabs, each thread's scalar float64 multiply-adds over a
// row-indexed float32 or float64 diagonal copy). Not built by the package:
// perf/vg_timing.py builds it beside csrc/centered_vg.cu as a yardstick,
// launches it on its own tiling and copy (vg_timing.pr12_tiling,
// pr12_band_diags), times both in the same run and holds the new kernel to
// it (float64 to 1e-12, float32 within twice its error against float64).
//
// The whitened, mode-centered FitzHugh-Nagumo value-and-grad between its
// two whitening GEMMs, forward and analytic backward in one launch.
//
// Per chain, from its row of dpsi = zeta W^T (C, dim), laid out
// [vec(dx) column-major; theta's z; log sigma if sampled]:
//
//   x = x_ref + dx, theta = z or lb + exp(z), sigma = exp(clamp(log sigma, +-15))
//   stage 1  u = mphi dx, v = GC^T dx        e = f(x, theta) - c_e - u
//                                            g = c_gc + v, r = mask (dx + r_ref)
//   stage 2  h = GK^T e
//   stage 3  ebar = GK (-h / beta_deriv)
//   stage 4  g_dx = J_x(f)^T ebar - mphi^T ebar + GC (-g / beta_level)
//                   - r / (sigma_d^2 beta_obs)
//   then lp, the theta gradient (sum_i J_theta(f)^T ebar, chained through
//   the transform) and the log-sigma gradient from the chain's sums.
//
// ops/centered_vg.py holds the formulas, the layouts of the constants and
// of the kernel's band copy, the tiling (``tiling``: the arithmetic of the
// launch below, mirrored) and the plain version this kernel is held to
// (chip_smoke.py's [vg]).
//
// Replaces no Pallas kernel: it replaces the JAX package's XLA-fused body
// of log_posterior_centered (manifold_constrained_gaussian_process_inference_tpu/
// ops/likelihood.py:386) under jax.value_and_grad as make_centered_whitened_vg
// (inference/whiten.py:527) builds it, which the port ran through autograd
// as ~140 small kernels, four of them K1's band launches (csrc/band_matvec.cu).
//
// What bounds it on an H100: six banded products of 2b+1 terms per output,
// 6 C D n (2b+1) multiply-adds (47 M at [slice]: C = 128, n = 397, b = 40,
// counting only the terms inside the grid; 1.4 us at the FP32 peak, 2.8 us
// at the FP64 peak the kernel's float64 arithmetic runs at), against ~2.4 MB
// of operands (0.7 us at 3.35 TB/s): bound by operations
// (ops/centered_vg.bound_work).
//
// Design: a thread-block cluster serves a group of Cg chains, and its S
// blocks split the grid's rows. The first design (one block per chain;
// perf/baselines/centered_vg_pr11.cu) streamed all six storages through
// one SM for every chain, converted every coefficient to float64 once per
// chain, and ran one dependent chain of multiply-adds per output. Here:
//
// - Rows over a cluster. Block `rank` of a cluster owns the slab of grid
//   rows [rank L, min(n, (rank + 1) L)), both states of each (stages 1 and
//   4 couple x[i] with x[n+i]), so each SM reads 1/S of the bands. S depends
//   on (n, b) alone: the largest power of two up to 16 (16 through the
//   non-portable cluster attribute) whose slabs keep at least max(b, 32)
//   rows, so that a halo comes from the adjacent blocks only.
// - Chains share coefficients. A thread's unit is kRows = 2 consecutive
//   rows of one state for G of the cluster's chains: it loads and converts
//   each coefficient once and runs G independent float64 multiply-adds on
//   it, and a sliding window of two values a chain reuses each staged
//   vector element for both rows. G is the largest of 8, 4, 2 that leaves a
//   block ~100 units (ops/centered_vg.tiling): on the H100 fewer units left
//   too few warps, more loaded and converted each coefficient again.
// - Coalesced, test-free coefficient loads. The kernel reads its own copy
//   of the six storages (ops/centered_vg.band_diags), indexed by row: a
//   unit's two rows of one term are one aligned 8- or 16-byte vector,
//   neighbouring threads' units neighbouring vectors, and zero padding past
//   the grid's edges and the last term means no load is tested. Each
//   chunk's loads are issued while the previous chunk is multiplied.
// - The chains' vectors are staged in shared memory in float64 (a float32
//   instance's values are its float32 roundings, converted once), each over
//   its slab and a halo of b rows each side, even positions then odd ones
//   (a unit's window reads are then consecutive across threads): X (dx, then
//   -h / beta_deriv), E (e, then ebar), GS (-g / beta_level). dx comes from
//   dpsi, halo and all; a stage's outputs in the first and last b rows of a
//   slab are also written into the adjacent block's halo (distributed
//   shared memory), and the cluster barrier after the stage publishes them.
//   A vector's halo is next written only after a barrier that follows every
//   read of it. A block that reads others' memory keeps them alive with a
//   last barrier. A cluster of one block uses the block's own barriers.
// - The arithmetic and order of every output are the first design's: the terms
//   k = -b..b of a row summed in ascending order by __fma_rn into one
//   float64 accumulator (a term outside the grid, or past a unit's last,
//   adds a zero coefficient times a zero, which leaves the sum's bits), every
//   product and sum in float64, rounded to the storage type where the first
//   design rounds (E, GS, H, g_psi); the quotients a chain's rows share (-1/c,
//   -b/c, c^2) are computed once, as the same operation on the same inputs.
//   So every per-row vector and the whole x block of g_psi are its bits
//   (perf/vg_timing.py checks it).
// - A chain's sums (lp, the theta and log-sigma gradients) change order:
//   each unit sums its rows in order, each block's units are reduced by a
//   fixed tree (a warp per chain: lanes take every 32nd unit, then
//   shuffles), and rank 0 adds the S blocks' partials in rank order. That
//   order depends on (n, b) alone, so a chain's bits do not depend on C, Cg,
//   G or which chains share its launch.
//
// Measured on the H100 (PERF.md, perf/vg_timing.py): 0.79x the first design's
// time at [slice], 0.38x at one chain, 0.48x at n = 3169; at [slice] the banded
// stages run at ~5% of the FP64 peak, bound by the coefficient path
// (loads and conversions) and by the few warps a block of ~100 units has.
//
// The launch (cudaLaunchKernelEx with the cluster dimension) goes on the
// caller's stream, allocates nothing and does not synchronise, so CUDA
// graphs, a WHILE node's body among them, capture it; centered_vg_init sets
// every instance's dynamic shared-memory limit and the non-portable cluster
// size once, at library load, and centered_vg_max_clusters answers whether a
// tiling can run at all (cudaOccupancyMaxActiveClusters).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 2;          // consecutive rows of a thread's unit
static_assert(kRows == 2, "a unit's rows of one term are one two-element vector, and its "
              "first row keeps the parity of its slab's first");
constexpr int kMaxThreads = 256;  // threads a block at most
constexpr int kMaxCluster = 16;
constexpr int kFill = 8;          // loads a thread keeps in flight filling X
constexpr int kSums = 8;    // sse_0, sse_1, |g|^2, |h|^2, g_a, g_b, g_c, spare
constexpr int kParams = 8;  // a, b, c, sigma_0^2, sigma_1^2, -1/c, -b/c, c^2
constexpr int kLanes = 4;   // the per-unit partial sums a stage keeps per chain
constexpr int kVectors = 3; // X (then H), E, GS
constexpr int kTheta = 3;
constexpr int kTail = 10;  // ops/centered_vg.TAIL
constexpr int kNPointers = 6, kNInts = 15;

enum Band { kMphi = 0, kGCt, kGKt, kGK, kMphiT, kGC };
enum Field { kXRef = 0, kRRef, kCE, kCGC, kMask };
enum Sum { kSse0 = 0, kSse1, kG2, kH2, kGa, kGb, kGc };
enum Vector { kXH = 0, kE, kGS };

template <typename T>
struct VgArgs {
  const T* dpsi;       // (C, dim)
  const T* band_diags;  // (6, 2, terms_of(b), cols_of(n)): term k of row i at [b + k][i]
  const T* fields;     // (5, 2, n)
  const T* scalars;    // beta (3), nobs (2), sigma (2), lb (3), center tail (5)
  T* g_psi;            // (C, dim)
  T* lp;               // (C,)
  int n_chains, n, bandwidth, dim, sigma_sampled, theta_kind;
  int cluster, slab, chains;  // S, L, Cg (ops/centered_vg.tiling)
  int split;                  // G = 1: a unit's two operators on two threads
};

// Every computation runs in float64 (the storage type T is float32 or
// float64: a float32 chain's vectors, operands and outputs are stored in
// float32 and rounded once on store), and every rounding is explicit: an
// intrinsic is never contracted into a fused multiply-add, which the
// compiler may choose differently in each instance of the kernel's
// template, so the instances would not share one order.
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double dvd(double a, double b) { return __ddiv_rn(a, b); }

__device__ __forceinline__ double clamp_keep_nan(double v, double lim) {
  return v < -lim ? -lim : (v > lim ? lim : v);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = add(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The two halves of a cluster barrier (cluster.sync() is both): arrive
// releases this thread's writes, shared and distributed; wait returns once
// every thread of the cluster has arrived, acquiring theirs.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A unit's kRows rows of one term are one vector; a chunk is U terms (8
// in float32, 4 in float64: 16 vectors, or 8, of each operator)
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float2;
  static constexpr int U = 8;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int U = 4;
};
__device__ __forceinline__ float pick(const float2& v, int i) { return i == 0 ? v.x : v.y; }
__device__ __forceinline__ double pick(const double2& v, int i) { return i == 0 ? v.x : v.y; }

// The kernel's diagonal copy of an operator: terms k = -b..b padded with
// zero terms to whole chunks of 8, and rows padded with zero rows below the
// grid to an even count, at least n + kRows (ops/centered_vg.diag_shape)
__host__ __device__ __forceinline__ int terms_of(int b) { return (2 * b + 1 + 7) / 8 * 8; }
__host__ __device__ __forceinline__ int cols_of(int n) { return (n + kRows + 1) / 2 * 2; }

// A staged vector keeps its even positions, then its odd ones, ``half``
// (width / 2) each: position p is element staged_at(p, half)
__device__ __forceinline__ int staged_at(int p, int half) { return (p & 1) * half + (p >> 1); }

// The shared memory of a block, in doubles per chain: the chain's
// parameters and sums, kLanes partial sums per unit of one state, and the
// kVectors staged vectors of both states, each `width` long
__host__ __device__ __forceinline__ int groups_of(int slab) { return (slab + kRows - 1) / kRows; }
__host__ __device__ __forceinline__ int width_of(int slab, int b) {
  return groups_of(slab) * kRows + 2 * b;
}
__host__ __device__ __forceinline__ size_t chain_doubles(int slab, int b) {
  // ops/centered_vg.chain_bytes
  return kParams + kSums + static_cast<size_t>(kLanes) * groups_of(slab) +
         static_cast<size_t>(kVectors) * 2 * width_of(slab, b);
}

// acc[j][r][g] += sum_k A_j[i0+r, i0+r+k] x_{j,g}[i0+r+k] for the rows
// i0 + r (r < kRows) of a unit, k = -b..b ascending: ``diags[j]`` points at
// operator j's entry (term -b, row i0) in the kernel's diagonal copy (term
// k of row i at [(b + k) cols + i], zero where i+k lies outside the grid,
// below the grid and past term b, so that no edge needs a test; a unit's
// kRows rows of one term are one aligned vector, and neighbouring threads'
// units are neighbouring vectors); xs[x][g] is chain g's staged vector
// (even positions, then odd ones, ``half`` each: staged_at) advanced to the
// unit's first row, so that row i0 + t - b is its element t (zero outside
// the grid), x = 0 for every j when NX is 1 (one vector, two operators),
// else x = j. Element t's parity is known when the code is compiled, and
// neighbouring threads read neighbouring doubles. A term outside a row's
// grid multiplies a zero coefficient by a zero, which leaves the sum's
// bits. Each coefficient is loaded and converted once for the G chains;
// each chain's window holds x[i0+k .. i0+k+kRows-1]. The next chunk's
// coefficients load while this chunk's are multiplied.
template <typename T, int NB, int NX, int G>
__device__ __forceinline__ void band_unit(const T* const (&diags)[NB], int cols,
                                          const double* const (&xs)[NX][G], int half, int b,
                                          double (&acc)[NB][kRows][G]) {
  using V = typename Vec<T>::type;
  constexpr int U = Vec<T>::U;
  V cur[NB][U], nxt[NB][U];
  double win[NX][G][kRows];
  // the chunk of U terms from term index t0 (= k + b): each operator's
  // kRows rows of a term in one vector
  auto load = [&](V (&to)[NB][U], int t0) {
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int u = 0; u < U; ++u)
        to[j][u] = __ldg(reinterpret_cast<const V*>(diags[j] + static_cast<ptrdiff_t>(t0 + u) * cols));
  };
  load(cur, 0);
#pragma unroll
  for (int x = 0; x < NX; ++x)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int r = 0; r + 1 < kRows; ++r) win[x][g][r + 1] = xs[x][g][(r & 1) * half + (r >> 1)];
  // term u of the chunk in cur, whose first term is element 2q of the unit
  auto term = [&](int u, int q) {
#pragma unroll
    for (int x = 0; x < NX; ++x)
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int r = 0; r + 1 < kRows; ++r) win[x][g][r] = win[x][g][r + 1];
        const int tt = u + kRows - 1;  // a constant once unrolled
        win[x][g][kRows - 1] = xs[x][g][(tt & 1) * half + q + (tt >> 1)];
      }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const double cf = pick(cur[j][u], r);
#pragma unroll
        for (int g = 0; g < G; ++g)
          acc[j][r][g] = fma_rn(cf, win[NX == 1 ? 0 : j][g][r], acc[j][r][g]);
      }
  };
  // whole chunks, each loading the next while it multiplies, then the
  // terms left (no loop below is cut short, so every array stays in
  // registers)
  const int terms = 2 * b + 1, full = terms / U, rem = terms - full * U;
  int q = 0;
  for (int m = 0; m < full; ++m, q += U / 2) {
    const bool more = m + 1 < full || rem > 0;  // the same at every thread
    if (more) load(nxt, 2 * q + U);
#pragma unroll
    for (int u = 0; u < U; ++u) term(u, q);
    if (more) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int u = 0; u < U; ++u) cur[j][u] = nxt[j][u];
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (u < rem) term(u, q);
}

// A stage's sums of every chain of the block: sum ``slot[q]`` of chain c is
// the sum of its partial lanes [first[q], first[q] + count[q]) (each lane
// ``groups`` entries, in order), reduced by one warp in a fixed tree (lane
// l adds entries l, l + 32, ... in order; then shuffles), into totals. A
// warp takes the block's NQ jobs of a chain at once.
template <int NQ>
__device__ __forceinline__ void reduce_parts(const double* parts, double* totals, int chains,
                                             int groups, const int (&first)[NQ],
                                             const int (&count)[NQ], const int (&slot)[NQ]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, warps = blockDim.x / 32;
  for (int c = warp; c < chains; c += warps) {
    double v[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const double* e = parts + (static_cast<size_t>(c) * kLanes + first[q]) * groups;
      const int entries = count[q] * groups;
      v[q] = lane < entries ? e[lane] : 0.0;
      for (int o = lane + 32; o < entries; o += 32) v[q] = add(v[q], e[o]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int q = 0; q < NQ; ++q) v[q] = add(v[q], __shfl_xor_sync(0xffffffffu, v[q], off));
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) totals[c * kSums + slot[q]] = v[q];
    }
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(kMaxThreads, 1) centered_vg_kernel(const VgArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = a.n, b = a.bandwidth, slab = a.slab, chains = a.chains, S = a.cluster;
  const int groups = groups_of(slab), width = width_of(slab, b), half = width / 2;
  const int rank = static_cast<int>(cluster.block_rank());
  const int c0 = (blockIdx.x / S) * chains;  // the cluster's first chain
  const int lo = rank * slab, hi = min(n, lo + slab);
  const int base = lo - b;  // the grid row of a staged vector's position 0
  // per chain: parameters, sums, partial lanes; then the vectors
  double* params = reinterpret_cast<double*>(smem_raw);
  double* totals = params + chains * kParams;
  double* parts = totals + chains * kSums;
  double* vec = parts + static_cast<size_t>(chains) * kLanes * groups;
  auto staged = [&](int v, int c, int d) {
    return vec + (static_cast<size_t>(v * chains + c) * 2 + d) * width;
  };
  auto lane_at = [&](int c, int lane, int rg) -> double& {
    return parts[(static_cast<size_t>(c) * kLanes + lane) * groups + rg];
  };
  // a value of row i (in this block's slab) of vector v: here, and in the
  // halo of the adjacent block whose rows are within b of it (a slab keeps
  // at least b rows, so only adjacent blocks read it)
  auto put = [&](int v, int c, int d, int i, double value) {
    double* mine = staged(v, c, d);
    mine[staged_at(i - base, half)] = value;
    if (rank > 0 && i < lo + b)
      cluster.map_shared_rank(mine, rank - 1)[staged_at(i - (lo - slab - b), half)] = value;
    if (rank + 1 < S && i >= hi - b)
      cluster.map_shared_rank(mine, rank + 1)[staged_at(i - hi + b, half)] = value;
  };
  // a staged value of this block's row i
  auto got = [&](int v, int c, int d, int i) { return staged(v, c, d)[staged_at(i - base, half)]; };

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const T* s = a.scalars;
  const double beta_deriv = s[0], beta_level = s[1], beta_obs = s[2];
  const int cols = cols_of(n);
  const size_t diag_size = static_cast<size_t>(terms_of(b)) * cols;  // one operator's copy
  auto diags_of = [&](int which, int d, int i0) {
    return a.band_diags + (which * 2 + d) * diag_size + i0;
  };
  auto field = [&](int which, int d, int i) -> double {
    return a.fields[(which * 2 + d) * n + min(i, n - 1)];
  };
  auto dx = [&](int c, int d, int i) -> T {
    const int chain = c0 + c;
    return chain < a.n_chains && i < n ? a.dpsi[static_cast<size_t>(chain) * a.dim + d * n + i]
                                       : T(0);
  };

  // dx over the slab and its halos, zero outside the grid (each thread's
  // loads in flight together, kFill at a time); E and GS zero; each chain's
  // theta and sigma^2, a thread each (a chain past C: finite stand-ins,
  // never stored)
  const int fill = 2 * chains * width;
  for (int o0 = tid; o0 < fill; o0 += kFill * nthreads) {
    double v[kFill];
    int at[kFill];
#pragma unroll
    for (int m = 0; m < kFill; ++m) {
      const int o = o0 + m * nthreads, cd = o / width, pos = o - cd * width, j = base + pos;
      at[m] = o < fill ? cd * width + staged_at(pos, half) : -1;
      v[m] = o < fill && j >= 0 ? static_cast<double>(dx(cd / 2, cd % 2, j)) : 0.0;
    }
#pragma unroll
    for (int m = 0; m < kFill; ++m)
      if (at[m] >= 0) vec[at[m]] = v[m];  // X of chain cd / 2, state cd % 2
  }
  {
    double* eg = staged(kE, 0, 0);  // E and GS, one after the other
    for (int o = tid; o < 2 * chains * 2 * width; o += nthreads) eg[o] = 0.0;
  }
  for (int o = tid; o < chains * 5; o += nthreads) {
    const int c = o / 5, m = o % 5, chain = c0 + c;
    double* p = params + c * kParams;
    const T* row = a.dpsi + static_cast<size_t>(chain) * a.dim;
    if (chain >= a.n_chains) {
      p[m] = 1.0;
    } else if (m < kTheta) {
      const double z = add(s[kTail + m], row[2 * n + m]);
      p[m] = a.theta_kind == 1 ? add(s[7 + m], exp(z)) : z;
    } else {
      const int d = m - kTheta;
      double sigma = s[5 + d];
      if (a.sigma_sampled)
        sigma = exp(clamp_keep_nan(add(s[kTail + kTheta + d], row[2 * n + kTheta + d]), 15.0));
      p[3 + d] = mul(sigma, sigma);
    }
  }
  __syncthreads();
  // the chain's quotients its rows share (each row's arithmetic had them)
  for (int c = tid; c < chains; c += nthreads) {
    double* p = params + c * kParams;
    p[5] = dvd(-1.0, p[2]), p[6] = dvd(-p[1], p[2]), p[7] = mul(p[2], p[2]);
  }
  // Barriers: a cluster of one block (a short grid) needs only the block's
  // own; arrive and wait are the halves of a cluster barrier
  auto sync_all = [&]() {
    if (S == 1) __syncthreads();
    else cluster.sync();
  };
  auto arrive = [&]() {
    if (S > 1) cluster_arrive();
  };
  auto wait = [&]() {
    if (S > 1) cluster_wait();
  };
  // every block of the cluster runs, and its E and GS are zero, before any
  // block writes into another's
  sync_all();

  // a unit: kRows rows of one state for G chains; a state's row groups
  // padded to whole warps (``span``), so that no warp holds both states'
  // units and runs both their epilogues (a padded unit has no rows and
  // keeps no sums)
  const int span = (groups + 31) / 32 * 32, units = 2 * span * (chains / G);

  // stage 1: u = mphi dx, v = GC^T dx; e, -g / beta_level; per unit the
  // sums of r^2 (lanes 0, 1 by state) and of g^2 (lanes 2, 3)
  if (G == 1 && a.split) {
    // one chain a unit: its two operators on neighbouring threads (item 0
    // mphi: e and the r^2 sums; item 1 GC^T: -g / beta_level and the g^2
    // sums), twice the threads of a block that has few
    for (int item = tid; item < 2 * units; item += nthreads) {
      const int o = item & 1, unit = item >> 1;
      const int rg = unit % span, d = (unit / span) % 2, c = unit / (2 * span);
      const int i0 = lo + rg * kRows;
      double s1 = 0.0;
      if (i0 < hi) {
        double xr0[kRows], xr1[kRows], cf[kRows], mask[kRows], rref[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int i = i0 + r;
          xr0[r] = field(kXRef, 0, i), xr1[r] = field(kXRef, 1, i);
          cf[r] = field(o == 0 ? kCE : kCGC, d, i);
          mask[r] = field(kMask, d, i), rref[r] = field(kRRef, d, i);
        }
        double acc[1][kRows][1] = {};
        const T* const diags[1] = {diags_of(o == 0 ? kMphi : kGCt, d, i0)};
        const double* const xs[1][1] = {{staged(kXH, c, d) + rg * (kRows / 2)}};
        band_unit<T, 1, 1, 1>(diags, cols, xs, half, b, acc);
        const double* p = params + c * kParams;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int i = i0 + r;
          if (i >= hi) continue;
          if (o == 0) {
            const double x0 = add(xr0[r], got(kXH, c, 0, i));
            const double x1 = add(xr1[r], got(kXH, c, 1, i));
            const double f = d == 0 ? mul(p[2], add(sub(x0, dvd(mul(mul(x0, x0), x0), 3.0)), x1))
                                    : mul(p[5], add(sub(x0, p[0]), mul(p[1], x1)));
            put(kE, c, d, i, static_cast<T>(sub(sub(f, cf[r]), acc[0][r][0])));
            const double rv = mul(mask[r], add(got(kXH, c, d, i), rref[r]));
            s1 = add(s1, mul(rv, rv));
          } else {
            const double gg = add(cf[r], acc[0][r][0]);
            put(kGS, c, d, i, static_cast<T>(dvd(-gg, beta_level)));
            s1 = add(s1, mul(gg, gg));
          }
        }
      }
      if (rg < groups) lane_at(c, o == 0 ? d : 2 + d, rg) = s1;
    }
  } else {
    for (int unit = tid; unit < units; unit += nthreads) {
      const int rg = unit % span, d = (unit / span) % 2, cs = unit / (2 * span);
      const int i0 = lo + rg * kRows;
      double s_rr[G], s_gg[G];
  #pragma unroll
      for (int g = 0; g < G; ++g) s_rr[g] = s_gg[g] = 0.0;
      if (i0 < hi) {
        double xr0[kRows], xr1[kRows], ce[kRows], cgc[kRows], mask[kRows], rref[kRows];
  #pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int i = i0 + r;
          xr0[r] = field(kXRef, 0, i), xr1[r] = field(kXRef, 1, i), ce[r] = field(kCE, d, i);
          cgc[r] = field(kCGC, d, i), mask[r] = field(kMask, d, i), rref[r] = field(kRRef, d, i);
        }
        double acc[2][kRows][G] = {};
        const T* const diags[2] = {diags_of(kMphi, d, i0), diags_of(kGCt, d, i0)};
        const double* xs[1][G];
  #pragma unroll
        for (int g = 0; g < G; ++g) xs[0][g] = staged(kXH, cs * G + g, d) + rg * (kRows / 2);
        band_unit<T, 2, 1, G>(diags, cols, xs, half, b, acc);
  #pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int i = i0 + r;
          if (i >= hi) continue;
  #pragma unroll
          for (int g = 0; g < G; ++g) {
            const int c = cs * G + g;
            const double* p = params + c * kParams;
            const double ta = p[0], tb = p[1], tc = p[2];
            const double x0 = add(xr0[r], got(kXH, c, 0, i));
            const double x1 = add(xr1[r], got(kXH, c, 1, i));
            const double f = d == 0 ? mul(tc, add(sub(x0, dvd(mul(mul(x0, x0), x0), 3.0)), x1))
                                    : mul(p[5], add(sub(x0, ta), mul(tb, x1)));
            put(kE, c, d, i, static_cast<T>(sub(sub(f, ce[r]), acc[0][r][g])));
            const double gg = add(cgc[r], acc[1][r][g]);
            put(kGS, c, d, i, static_cast<T>(dvd(-gg, beta_level)));
            const double rv = mul(mask[r], add(got(kXH, c, d, i), rref[r]));
            s_rr[g] = add(s_rr[g], mul(rv, rv));
            s_gg[g] = add(s_gg[g], mul(gg, gg));
          }
        }
      }
      if (rg < groups) {
  #pragma unroll
        for (int g = 0; g < G; ++g) {
          lane_at(cs * G + g, d, rg) = s_rr[g];
          lane_at(cs * G + g, 2 + d, rg) = s_gg[g];
        }
      }
    }
  }
  __syncthreads();
  arrive();
  {
    const int first[3] = {0, 1, 2}, count[3] = {1, 1, 2}, slot[3] = {kSse0, kSse1, kG2};
    reduce_parts<3>(parts, totals, chains, groups, first, count, slot);
  }
  __syncthreads();
  wait();  // E and GS complete, halos included

  // stage 2: h = GK^T e; -h / beta_deriv into X; per unit |h|^2 (lanes 0, 1)
  for (int unit = tid; unit < units; unit += nthreads) {
    const int rg = unit % span, d = (unit / span) % 2, cs = unit / (2 * span);
    const int i0 = lo + rg * kRows;
    double s_h[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s_h[g] = 0.0;
    if (i0 < hi) {
      double acc[1][kRows][G] = {};
      const T* const diags[1] = {diags_of(kGKt, d, i0)};
      const double* xs[1][G];
#pragma unroll
      for (int g = 0; g < G; ++g) xs[0][g] = staged(kE, cs * G + g, d) + rg * (kRows / 2);
      band_unit<T, 1, 1, G>(diags, cols, xs, half, b, acc);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = i0 + r;
        if (i >= hi) continue;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const double h = acc[0][r][g];
          s_h[g] = add(s_h[g], mul(h, h));
          put(kXH, cs * G + g, d, i, static_cast<T>(dvd(-h, beta_deriv)));
        }
      }
    }
    if (rg < groups) {
#pragma unroll
      for (int g = 0; g < G; ++g) lane_at(cs * G + g, d, rg) = s_h[g];
    }
  }
  __syncthreads();
  arrive();
  {
    const int first[1] = {0}, count[1] = {2}, slot[1] = {kH2};
    reduce_parts<1>(parts, totals, chains, groups, first, count, slot);
  }
  __syncthreads();
  wait();  // H complete

  // stage 3: ebar = GK (-h / beta_deriv), into E
  for (int unit = tid; unit < units; unit += nthreads) {
    const int rg = unit % span, d = (unit / span) % 2, cs = unit / (2 * span);
    const int i0 = lo + rg * kRows;
    if (i0 >= hi) continue;
    double acc[1][kRows][G] = {};
    const T* const diags[1] = {diags_of(kGK, d, i0)};
    const double* xs[1][G];
#pragma unroll
    for (int g = 0; g < G; ++g) xs[0][g] = staged(kXH, cs * G + g, d) + rg * (kRows / 2);
    band_unit<T, 1, 1, G>(diags, cols, xs, half, b, acc);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      if (i >= hi) continue;
#pragma unroll
      for (int g = 0; g < G; ++g) put(kE, cs * G + g, d, i, static_cast<T>(acc[0][r][g]));
    }
  }
  sync_all();  // ebar complete

  // stage 4: the gradient in dx; per unit the theta gradient's sums (g_c
  // in lanes 0, 1 by state; g_a, g_b of state 1 in lanes 2, 3)
  if (G == 1 && a.split) {
    // one chain a unit: mphi^T ebar on item 0, GC (-g / beta_level) on item
    // 1, whose sums item 0 takes by a shuffle before its epilogue (every
    // thread runs the same passes, so that each pair exchanges)
    for (int first = 0; first < 2 * units; first += nthreads) {
      const int item = first + tid, o = item & 1, unit = min(item, 2 * units - 1) >> 1;
      const int rg = unit % span, d = (unit / span) % 2, c = unit / (2 * span);
      const int i0 = lo + rg * kRows, chain = c0 + c;
      const bool live = item < 2 * units, rows = live && i0 < hi;
      double acc[1][kRows][1] = {};
      double xr0[kRows], xr1[kRows], mask[kRows], rref[kRows];
      T dx0[kRows], dx1[kRows];
      if (rows) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int i = i0 + r;
          xr0[r] = field(kXRef, 0, i), xr1[r] = field(kXRef, 1, i);
          mask[r] = field(kMask, d, i), rref[r] = field(kRRef, d, i);
          dx0[r] = dx(c, 0, i), dx1[r] = dx(c, 1, i);
        }
        const T* const diags[1] = {diags_of(o == 0 ? kMphiT : kGC, d, i0)};
        const double* const xs[1][1] = {{staged(o == 0 ? kE : kGS, c, d) + rg * (kRows / 2)}};
        band_unit<T, 1, 1, 1>(diags, cols, xs, half, b, acc);
      }
      double other[kRows];  // item 1's sums, at item 0
#pragma unroll
      for (int r = 0; r < kRows; ++r) other[r] = __shfl_xor_sync(0xffffffffu, acc[0][r][0], 1);
      double s_a = 0.0, s_b = 0.0, s_c = 0.0;
      if (rows && o == 0) {
        const double* p = params + c * kParams;
        const double ta = p[0], tb = p[1], tc = p[2];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int i = i0 + r;
          if (i >= hi) continue;
          const double x0 = add(xr0[r], dx0[r]), x1 = add(xr1[r], dx1[r]);
          const double e0 = got(kE, c, 0, i), e1 = got(kE, c, 1, i);
          double jx;
          if (d == 0) {
            jx = add(mul(e0, mul(tc, sub(1.0, mul(x0, x0)))), mul(e1, p[5]));
            s_c = add(s_c, mul(e0, add(sub(x0, dvd(mul(mul(x0, x0), x0), 3.0)), x1)));
          } else {
            jx = add(mul(e0, tc), mul(e1, p[6]));
            s_a = add(s_a, dvd(e1, tc));
            s_b = add(s_b, mul(e1, dvd(-x1, tc)));
            s_c = add(s_c, mul(e1, dvd(add(sub(x0, ta), mul(tb, x1)), p[7])));
          }
          const double rv = mul(mask[r], add(d == 0 ? dx0[r] : dx1[r], rref[r]));
          if (chain < a.n_chains)
            a.g_psi[static_cast<size_t>(chain) * a.dim + d * n + i] = static_cast<T>(
                sub(add(sub(jx, acc[0][r][0]), other[r]), dvd(rv, mul(p[3 + d], beta_obs))));
        }
      }
      if (live && o == 0 && rg < groups) {
        lane_at(c, d, rg) = s_c;
        if (d == 1) lane_at(c, 2, rg) = s_a, lane_at(c, 3, rg) = s_b;
      }
    }
  } else {
    for (int unit = tid; unit < units; unit += nthreads) {
      const int rg = unit % span, d = (unit / span) % 2, cs = unit / (2 * span);
      const int i0 = lo + rg * kRows;
      double s_a[G], s_b[G], s_c[G];
  #pragma unroll
      for (int g = 0; g < G; ++g) s_a[g] = s_b[g] = s_c[g] = 0.0;
      if (i0 < hi) {
        double xr0[kRows], xr1[kRows], mask[kRows], rref[kRows];
        T dx0[kRows][G], dx1[kRows][G];
  #pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int i = i0 + r;
          xr0[r] = field(kXRef, 0, i), xr1[r] = field(kXRef, 1, i);
          mask[r] = field(kMask, d, i), rref[r] = field(kRRef, d, i);
  #pragma unroll
          for (int g = 0; g < G; ++g) dx0[r][g] = dx(cs * G + g, 0, i), dx1[r][g] = dx(cs * G + g, 1, i);
        }
        double acc[2][kRows][G] = {};
        const T* const diags[2] = {diags_of(kMphiT, d, i0), diags_of(kGC, d, i0)};
        const double* xs[2][G];
  #pragma unroll
        for (int g = 0; g < G; ++g) {
          xs[0][g] = staged(kE, cs * G + g, d) + rg * (kRows / 2);
          xs[1][g] = staged(kGS, cs * G + g, d) + rg * (kRows / 2);
        }
        band_unit<T, 2, 2, G>(diags, cols, xs, half, b, acc);
  #pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int i = i0 + r;
          if (i >= hi) continue;
  #pragma unroll
          for (int g = 0; g < G; ++g) {
            const int c = cs * G + g, chain = c0 + c;
            const double* p = params + c * kParams;
            const double ta = p[0], tb = p[1], tc = p[2];
            const double x0 = add(xr0[r], dx0[r][g]), x1 = add(xr1[r], dx1[r][g]);
            const double e0 = got(kE, c, 0, i), e1 = got(kE, c, 1, i);
            double jx;
            if (d == 0) {
              jx = add(mul(e0, mul(tc, sub(1.0, mul(x0, x0)))), mul(e1, p[5]));
              s_c[g] = add(s_c[g], mul(e0, add(sub(x0, dvd(mul(mul(x0, x0), x0), 3.0)), x1)));
            } else {
              jx = add(mul(e0, tc), mul(e1, p[6]));
              s_a[g] = add(s_a[g], dvd(e1, tc));
              s_b[g] = add(s_b[g], mul(e1, dvd(-x1, tc)));
              s_c[g] = add(s_c[g], mul(e1, dvd(add(sub(x0, ta), mul(tb, x1)), p[7])));
            }
            const double rv = mul(mask[r], add(d == 0 ? dx0[r][g] : dx1[r][g], rref[r]));
            if (chain < a.n_chains)
              a.g_psi[static_cast<size_t>(chain) * a.dim + d * n + i] = static_cast<T>(
                  sub(add(sub(jx, acc[0][r][g]), acc[1][r][g]), dvd(rv, mul(p[3 + d], beta_obs))));
          }
        }
      }
      if (rg < groups) {
  #pragma unroll
        for (int g = 0; g < G; ++g) {
          lane_at(cs * G + g, d, rg) = s_c[g];
          if (d == 1) {
            lane_at(cs * G + g, 2, rg) = s_a[g];
            lane_at(cs * G + g, 3, rg) = s_b[g];
          }
        }
      }
    }
  }
  __syncthreads();
  {
    const int first[3] = {0, 2, 3}, count[3] = {2, 1, 1}, slot[3] = {kGc, kGa, kGb};
    reduce_parts<3>(parts, totals, chains, groups, first, count, slot);
  }
  sync_all();  // every block's sums complete

  // rank 0: each chain's sums, the blocks' partials in rank order (a thread
  // a chain and sum, every partial loaded before the first add), into the
  // parameters' spare slots; then no block needs its shared memory
  if (rank == 0) {
    for (int o = tid; o < chains * (kSums - 1); o += nthreads) {
      const int c = o / (kSums - 1), j = o % (kSums - 1);
      double part[kMaxCluster];
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        part[q] = q == 0 ? totals[c * kSums + j]
                         : q < S ? cluster.map_shared_rank(totals, q)[c * kSums + j] : 0.0;
      double t = part[0];
#pragma unroll
      for (int q = 1; q < kMaxCluster; ++q)
        if (q < S) t = add(t, part[q]);
      parts[o] = t;  // every block's stage sums are read: parts is free
    }
  }
  sync_all();
  if (rank != 0) return;

  // rank 0, a thread per chain: lp and the gradient's tail
  for (int c = tid; c < chains; c += nthreads) {
    const int chain = c0 + c;
    if (chain >= a.n_chains) continue;
    const double* tot = parts + c * (kSums - 1);
    const double* p = params + c * kParams;
    const T* row = a.dpsi + static_cast<size_t>(chain) * a.dim;
    T* grow = a.g_psi + static_cast<size_t>(chain) * a.dim;
    const double log2pi = 1.8378770664093453;
    double obs = 0.0;
    for (int d = 0; d < 2; ++d)
      obs = add(obs, add(dvd(tot[kSse0 + d], p[3 + d]),
                         mul(s[3 + d], add(log2pi, log(p[3 + d])))));
    const double quad = add(dvd(tot[kH2], beta_deriv), dvd(tot[kG2], beta_level));
    double jac = 0.0;
    bool has_jac = false;
    const double g_theta[kTheta] = {tot[kGa], tot[kGb], tot[kGc]};
    if (a.theta_kind == 1) {
      double zsum = 0.0;
      for (int m = 0; m < kTheta; ++m) {
        const double z = add(s[kTail + m], row[2 * n + m]);
        zsum = add(zsum, z);
        grow[2 * n + m] = T(add(mul(g_theta[m], exp(z)), 1.0));
      }
      jac = zsum;
      has_jac = true;
    } else {
      for (int m = 0; m < kTheta; ++m) grow[2 * n + m] = T(g_theta[m]);
    }
    if (a.sigma_sampled) {
      double lsum = 0.0;
      for (int d = 0; d < 2; ++d) {
        const double ls = add(s[kTail + kTheta + d], row[2 * n + kTheta + d]);
        lsum = add(lsum, clamp_keep_nan(ls, 15.0));
        const bool inside = ls >= -15.0 && ls <= 15.0;
        grow[2 * n + kTheta + d] =
            T(inside ? add(dvd(sub(dvd(tot[kSse0 + d], p[3 + d]), s[3 + d]), beta_obs), 1.0)
                     : 0.0);
      }
      jac = has_jac ? add(jac, lsum) : lsum;
    }
    a.lp[chain] = T(add(mul(-0.5, add(dvd(obs, beta_obs), quad)), jac));
  }
}

// The launch's integer arguments, in the order of ops/centered_vg.INTS
struct Launch {
  int n_chains, n, bandwidth, dim, sigma_sampled, theta_kind, cluster, slab, chains,
      per_thread, split, threads;
  long long shared;
};

template <typename T>
void (*kernel_for(int per_thread))(const VgArgs<T>) {
  return per_thread == 8   ? centered_vg_kernel<T, 8>
         : per_thread == 4 ? centered_vg_kernel<T, 4>
         : per_thread == 2 ? centered_vg_kernel<T, 2>
                           : centered_vg_kernel<T, 1>;
}

// The launch's checks: the tiling is one that ops/centered_vg.tiling gives
bool valid(const Launch& l) {
  return l.cluster >= 1 && l.cluster <= kMaxCluster && l.slab >= 1 &&
         (l.cluster == 1 || (l.slab >= l.bandwidth && l.slab % 2 == 0)) &&
         static_cast<long long>(l.slab) * l.cluster >= l.n &&
         static_cast<long long>(l.slab) * (l.cluster - 1) < l.n && l.chains >= 1 &&
         (l.per_thread == 1 || l.per_thread == 2 || l.per_thread == 4 || l.per_thread == 8) &&
         l.chains % l.per_thread == 0 && (l.split == 0 || (l.split == 1 && l.per_thread == 1)) &&
         l.threads >= 32 && l.threads <= kMaxThreads &&
         l.threads % 32 == 0 &&
         l.shared == static_cast<long long>(sizeof(double) * l.chains *
                                            chain_doubles(l.slab, l.bandwidth));
}

Launch parse(const long long* ints) {
  Launch l;
  l.n_chains = static_cast<int>(ints[0]);
  l.n = static_cast<int>(ints[1]);
  l.bandwidth = static_cast<int>(ints[2]);
  l.dim = static_cast<int>(ints[3]);
  l.sigma_sampled = static_cast<int>(ints[4]);
  l.theta_kind = static_cast<int>(ints[5]);
  l.cluster = static_cast<int>(ints[6]);
  l.slab = static_cast<int>(ints[7]);
  l.chains = static_cast<int>(ints[8]);
  l.per_thread = static_cast<int>(ints[9]);
  l.split = static_cast<int>(ints[10]);
  l.threads = static_cast<int>(ints[11]);
  l.shared = ints[12];
  return l;
}

cudaLaunchConfig_t config_for(const Launch& l, int clusters, cudaStream_t stream,
                              cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(l.cluster * clusters), 1, 1);
  config.blockDim = dim3(static_cast<unsigned>(l.threads), 1, 1);
  config.dynamicSmemBytes = static_cast<size_t>(l.shared);
  config.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(l.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

template <typename T>
int launch(const void* const* ptrs, const long long* ints, void* stream) {
  if (ints[13] != kNPointers || ints[14] != kNInts) return static_cast<int>(cudaErrorInvalidValue);
  const Launch l = parse(ints);
  if (l.n_chains <= 0) return 0;
  if (!valid(l)) return static_cast<int>(cudaErrorInvalidValue);
  VgArgs<T> a;
  a.dpsi = static_cast<const T*>(ptrs[0]);
  a.band_diags = static_cast<const T*>(ptrs[1]);
  a.fields = static_cast<const T*>(ptrs[2]);
  a.scalars = static_cast<const T*>(ptrs[3]);
  a.g_psi = static_cast<T*>(const_cast<void*>(ptrs[4]));
  a.lp = static_cast<T*>(const_cast<void*>(ptrs[5]));
  a.n_chains = l.n_chains;
  a.n = l.n;
  a.bandwidth = l.bandwidth;
  a.dim = l.dim;
  a.sigma_sampled = l.sigma_sampled;
  a.theta_kind = l.theta_kind;
  a.cluster = l.cluster;
  a.slab = l.slab;
  a.chains = l.chains;
  a.split = l.split;
  cudaLaunchAttribute attr[1];
  const int clusters = (l.n_chains + l.chains - 1) / l.chains;
  const cudaLaunchConfig_t config =
      config_for(l, clusters, static_cast<cudaStream_t>(stream), attr);
  return static_cast<int>(cudaLaunchKernelEx(&config, kernel_for<T>(l.per_thread), a));
}

template <typename T>
cudaError_t init_instances() {
  int dev = 0, bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  for (int g : {1, 2, 4, 8}) {
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel_for<T>(g), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel_for<T>(g),
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return err;
}

}  // namespace

extern "C" {

// Every instance may use the device's whole opt-in shared memory a block
// and clusters of up to 16 blocks.
int centered_vg_init() {
  cudaError_t err = init_instances<float>();
  if (err == cudaSuccess) err = init_instances<double>();
  return static_cast<int>(err);
}

// How many clusters of the launch ``ints`` describes (the kernel's integer
// arguments) the device can run at once, into *out (0: it cannot run);
// ``f64`` picks the instance. Returns the CUDA error.
int centered_vg_max_clusters(const long long* ints, int f64, int* out) {
  *out = 0;
  const Launch l = parse(ints);
  if (!valid(l)) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t config = config_for(l, 1, nullptr, attr);
  const void* fn = f64 ? reinterpret_cast<const void*>(kernel_for<double>(l.per_thread))
                       : reinterpret_cast<const void*>(kernel_for<float>(l.per_thread));
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, fn, &config));
}

int centered_vg_f32(const void* const* ptrs, const long long* ints, void* stream) {
  return launch<float>(ptrs, ints, stream);
}

int centered_vg_f64(const void* const* ptrs, const long long* ints, void* stream) {
  return launch<double>(ptrs, ints, stream);
}

}  // extern "C"
