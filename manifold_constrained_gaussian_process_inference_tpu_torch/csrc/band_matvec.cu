// Stacked banded matvecs in diagonal band storage, with a native chain axis.
//
//   y[c, m, i] = sum_{k=-b..b} bands[m, b+k, i+k] * xs[c, m, i+k]
//
// with zero terms where i+k lies outside [0, n). Row b+k of the band
// storage holds the diagonal with offset k, indexed by its COLUMN i+k
// (ops/band.py dense_to_band_storage). The bands (M, W=2b+1, n) are shared
// by all C chains; xs and y are (C, M, n), contiguous. Three entry points
// share one kernel template:
//   band_matvec         y = A x
//   band_matvec_pair    y_a = A x, y_b = B x        (one input, two stacks)
//   band_matvec_pair_t  y = A x_a + B x_b           (its backward: A, B are
//                                                    the transposed stacks)
// so that one likelihood evaluation launches two kernels forward and two
// backward (ops/likelihood.py).
//
// Replaces the Pallas TPU kernel
// manifold_constrained_gaussian_process_inference_tpu/ops/pallas_band.py
// (_band_matvec_kernel, launched by _pallas_band_matvec_impl), which ran one
// (M, n) problem in VMEM per call and unrolled the W diagonals as lane rolls.
//
// What bounds it on an H100: per output, W multiply-adds against 8 bytes
// of x and y, so at the filllevel-5 grid (C=128, M=2, b=160, n=3169) the
// 254 M FMAs take 7.6 us at the FP32 peak against 4.4 us for the 14.6 MB
// moved: bound by FP32 throughput. At the slice's shape (b=40, n=397) the
// 1.07 MB take 0.32 us: bound by bytes, and in practice by latency.
//
// Chain tile (the design for many chains): the work is Y_m (n x C) =
// A_m X_m, a banded product over a tile of chains, worked through the diagonals in chunks as a GEMM works
// through its K loop. A block owns one operator m, T output rows and CB
// chains; each thread holds RI consecutive rows x RC chains of outputs in
// registers. G groups of threads split each chunk's WK diagonals and sum
// their partial outputs through shared memory at the end (in group order,
// so the result does not depend on timing). Per chunk the block stages in
// shared memory, by cp.async with zero fill (so the halo outside [0, n)
// and the diagonals past W cost no branch in the FMA loop):
//   bandS[w][t] = bands[m, w0+w, i0+w0+w-b+t]   (WK x T, the diagonals
//                  sheared so that row t holds output row i0+t's terms)
// into one of STAGES slots, and the x rows that chunk brings into view,
//   xS[r][c]    = xs[c0+c, m, i0-b+r]            (a ring of rows x CB
//                  chains, chain-minor so a thread reads 4 chains at once)
// so that each x row is copied once per block and the next chunks' copies
// overlap this chunk's FMAs. A band coefficient leaves device memory once
// per chain tile (not once per chain). A thread's x rows form a window
// that slides one row per diagonal: RI rows in registers, rotated by
// unrolling RI diagonals, so each diagonal costs one vector load of x per
// 4 chains and RI band values for RI x RC FMAs. Shared memory is sized by
// the chunk, not by W: any bandwidth runs. FP32 FMA on the CUDA cores (no
// TF32: the MAGI operators need full float32 products); float64 for the
// parity checks.
//
// Where it stands (PERF.md): at the slice's shape it is 2-3x faster than
// the dense torch.matmul; at n=3169, b=160 it is 4-5x faster than the
// matmul but about 4x its FP32 bound. Timed alone, the staging and the FMA
// loop each take most of the kernel's time: the 4-byte cp.async copies
// (the rows are not 16-byte aligned) and the shared-memory loads of the
// FMA loop are what a faster design has to cut.
//
// Row tile, for few chains (ops/cuda_band.tile_for picks it for at most 8
// chains, the most it takes; the C sweep of perf/band_timing.py found it
// ahead of the chain tile, or within 3%, at every C <= 8). At a few
// chains each band coefficient serves a few FMAs, far under the card's
// balance point: the tile is bound by the band's bytes, and what it needs
// is many bytes in flight on many SMs. The chain tile at C = 1 runs all 32
// or 64 chain lanes of its tile for one useful chain, and its 64-row blocks
// leave most SMs idle (36 blocks at n = 1113, M = 2). A row block owns one
// operator m and only T = 16 output rows of every chain (140 blocks at
// n = 1113), and all its 128 threads stage the sheared diagonals of the
// next chunks by cp.async (STAGES = 4 slots: 3 and 8 were no faster at
// C = 1, and 8 halved the blocks resident at C = 8), so the copies in
// flight do not depend on the few threads that accumulate; the x rows of
// each chain are staged once per block into a ring, as in the chain tile.
// Shared memory is sized by the chunk, not by b. At C = 1 it is faster than
// the batched GEMV and the plain version at every shape measured, at
// 1.6-2.5x its bytes bound at n = 3169, b = 160 (PERF.md); at smaller
// shapes it is bound by latency (2.2-2.6 us at n = 397).
//
// Order invariant: a chain's outputs do not depend on the tile, so a batch
// split over ranks (or a chain run alone) computes what the whole batch
// computes, bit for bit. Both tiles sum each output's terms in one order:
// chunks of WK = 32 diagonals; G groups each take WKG consecutive diagonals
// of every chunk into one accumulator, sequentially over the chunks and
// the diagonals (up to 2b+1 rounded up to a multiple of the chain tile's
// RI, the padding contributing exact zeros); group 0 then adds groups 1..G-1
// in order. Every update is an explicit fused multiply-add (madd). The row
// tile takes G and WKG from the chain tile of the same dtype and width
// (Small: G = 4, WKG = 8; Large: G = 2, WKG = 16), and its thread (g, t)
// holds group g's accumulators of output row t for every chain: the chain
// tile's order with its chain lanes dropped.
//
// Measurement variants, built only by perf/band_timing.py (which prepends
// the define to a copy of this source; the shipped library defines none):
//   BAND_ABLATE_NO_STAGE     the staging is skipped (wrong results)
//   BAND_ABLATE_NO_FMA       the FMA loop is skipped (wrong results)
//   BAND_ROW_STAGES k        the row tile keeps k chunks in flight

#include <cuda_runtime.h>

#include <cstddef>

namespace {

template <typename T>
struct Args {
  const T* bands[2];
  const T* xs[2];
  T* ys[2];
  int n_chains, n_mat, n, bandwidth;
};

constexpr int pow2_at_least(int v) { return v <= 1 ? 1 : 2 * pow2_at_least((v + 1) / 2); }

constexpr int kRowMaxChains = 8;  // the most chains the row tile takes

// RI output rows x 4*CQ chains per thread; a group of RG x CG threads
// covers the block's outputs, and G groups split each chunk's WK diagonals
// between them (WK / G each), summing their partial outputs at the end;
// STAGES chunks in flight.
template <int RI_, int CQ_, int RG_, int CG_, int G_, int WK_, int STAGES_>
struct Tile {
  static constexpr int RI = RI_, CQ = CQ_, RC = 4 * CQ_;
  static constexpr int CG = CG_, G = G_, GROUP = RG_ * CG_, THREADS = G_ * RG_ * CG_;
  static constexpr int T = RI_ * RG_;      // output rows per block
  static constexpr int CB = 4 * CQ_ * CG_;  // chains per block
  static constexpr int WK = WK_, WKG = WK_ / G_, STAGES = STAGES_;
  // x rows live in a ring of XR rows (a power of two): the chunks in
  // flight need STAGES * WK + T of them
  static constexpr int XR = pow2_at_least(STAGES_ * WK_ + T);
  // x row stride: keeps rows 16-byte aligned, and a warp's staging writes
  // (8 rows x 4 chains) fall in 32 distinct banks when CB % 8 == 0.
  static constexpr int XS = CB + 4;
  static_assert(WKG % RI == 0 && T % 8 == 0 && WK % 8 == 0 && CB % 8 == 0 && RI % 4 == 0,
                "tile shape");
};

template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? BYTES : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(gmem),
               "n"(BYTES), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four consecutive values from 16-byte aligned shared memory
__device__ __forceinline__ void lds4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

__device__ __forceinline__ void lds4(const double* p, double* o) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

// acc + coef * x, rounded once: every term of both tiles goes through it,
// so that their sums agree bit for bit
__device__ __forceinline__ float madd(float coef, float x, float acc) {
  return __fmaf_rn(coef, x, acc);
}

__device__ __forceinline__ double madd(double coef, double x, double acc) {
  return __fma_rn(coef, x, acc);
}

// NB band stacks; SUM: NB inputs summed into one output, else one input
// into NB outputs.
template <typename T, class L, int NB, bool SUM>
__global__ void __launch_bounds__(L::THREADS) band_matvec_kernel(const Args<T> a) {
  constexpr int NX = SUM ? NB : 1, NY = SUM ? 1 : NB;
  constexpr int BAND_ELEMS = L::WK * L::T, X_ELEMS = L::XR * L::XS;
  constexpr int NWARPS = L::THREADS / 32;
  static_assert(L::THREADS % L::T == 0 && L::WK % (L::THREADS / L::T) == 0 &&
                L::THREADS % 32 == 0 && (L::CB / 4) % NWARPS == 0, "staging loops");
  // shared memory: STAGES slots of NB band tiles, then NX rings of x rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T* ring = smem + L::STAGES * NB * BAND_ELEMS;

  const int n = a.n, b = a.bandwidth, width = 2 * b + 1;
  const int m = blockIdx.z;
  const int i0 = blockIdx.x * L::T;
  const int c0 = blockIdx.y * L::CB;
  const int tid = threadIdx.x;
  const int group = tid / L::GROUP, gtid = tid % L::GROUP;
  const int cg = gtid % L::CG;
  const int il = (gtid / L::CG) * L::RI;  // the thread's first row in the tile
  const int w_pad = (width + L::RI - 1) / L::RI * L::RI;
  const int n_chunks = (w_pad + L::WK - 1) / L::WK;
  const size_t chain_stride = static_cast<size_t>(a.n_mat) * a.n;
  const size_t band_base = static_cast<size_t>(m) * width * n;

  // Staging, with the addresses stepped rather than recomputed, so that
  // they cost a few registers. Bands: thread t = tid % T copies column t of
  // every (THREADS / T)-th sheared row of the chunk. x: row r of the ring
  // holds x[., m, i0 - b + r] (r mod XR); chunk k brings rows
  // [T + k WK, T + (k+1) WK), chunk 0 also rows [0, T). Warp wq copies chain
  // quads wq, wq + NWARPS, ..., lane (r8, c4) = (lane / 4, lane % 4) row r8
  // of every block of 8 rows of chain c4 of the quad: 32-byte pieces of 4
  // chains.
  const int t_col = tid % L::T;
  const int w_first = tid / L::T;
  constexpr int W_STEP = L::THREADS / L::T;
  const int lane = tid & 31, warp = tid >> 5;
  const int r8 = lane >> 2, c4 = lane & 3;
  auto stage = [&](int chunk) {
#ifdef BAND_ABLATE_NO_STAGE
    if (n > 0) return;
#endif
    T* st = smem + (chunk % L::STAGES) * NB * BAND_ELEMS;
    const int w0 = chunk * L::WK;
    {
      int w = w0 + w_first;
      int j = i0 - b + w + t_col;
      size_t off = band_base + static_cast<size_t>(w) * n + j;
      T* dst = st + w_first * L::T + t_col;
#pragma unroll 4
      for (int it = 0; it < L::WK / W_STEP; ++it) {
        const bool ok = w < width && static_cast<unsigned>(j) < static_cast<unsigned>(n);
#pragma unroll
        for (int s = 0; s < NB; ++s)
          cp_async_zfill<sizeof(T)>(dst + s * BAND_ELEMS, a.bands[s] + (ok ? off : 0), ok);
        w += W_STEP;
        j += W_STEP;
        off += static_cast<size_t>(W_STEP) * (n + 1);
        dst += W_STEP * L::T;
      }
    }
    const int r_lo = chunk == 0 ? 0 : L::T + w0;
    const int n_blocks8 = (chunk == 0 ? L::T + L::WK : L::WK) / 8;
    for (int quad = warp; quad < L::CB / 4; quad += NWARPS) {
      const int c = quad * 4 + c4;
      const bool chain_ok = c0 + c < a.n_chains;
      int r = r_lo + r8;
      int j = i0 - b + r;
      size_t off = chain_ok ? (c0 + c) * chain_stride + static_cast<size_t>(m) * n + j : 0;
#pragma unroll 4
      for (int rb = 0; rb < n_blocks8; ++rb) {
        const bool ok = chain_ok && static_cast<unsigned>(j) < static_cast<unsigned>(n);
        T* dst = ring + (r & (L::XR - 1)) * L::XS + c;
#pragma unroll
        for (int s = 0; s < NX; ++s)
          cp_async_zfill<sizeof(T)>(dst + s * X_ELEMS, a.xs[s] + (ok ? off : 0), ok);
        r += 8;
        j += 8;
        off += 8;
      }
    }
  };

  // x row r (of the ring) of input s, this thread's chains, into dst[RC]
  auto load_row = [&](int s, int r, T* dst) {
    const T* row = ring + s * X_ELEMS + (r & (L::XR - 1)) * L::XS + cg * 4;
#pragma unroll
    for (int q = 0; q < L::CQ; ++q) lds4(row + q * 4 * L::CG, dst + 4 * q);
  };

  T acc[NY][L::RI][L::RC];
#pragma unroll
  for (int y = 0; y < NY; ++y)
#pragma unroll
    for (int p = 0; p < L::RI; ++p)
#pragma unroll
      for (int q = 0; q < L::RC; ++q) acc[y][p][q] = T(0);
  // win[s][(step + p) % RI] holds x row (il + p + diagonal) of input s
  T win[NX][L::RI][L::RC];

#pragma unroll
  for (int k = 0; k < L::STAGES - 1; ++k) {
    if (k < n_chunks) stage(k);
    cp_async_commit();
  }
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    cp_async_wait<L::STAGES - 2>();
    __syncthreads();  // this chunk has landed; the slots refilled below are free
    const int ahead = chunk + L::STAGES - 1;
    if (ahead < n_chunks) stage(ahead);
    cp_async_commit();

    const T* st = smem + (chunk % L::STAGES) * NB * BAND_ELEMS;
    // this group's diagonals of the chunk: [w_lo, w_hi) within it
    const int w_lo = group * L::WKG;
    const int w_hi = min(w_lo + L::WKG, w_pad - chunk * L::WK);
    const int r0 = il + chunk * L::WK;  // x row of diagonal 0 of the chunk
    if (w_lo < w_hi) {
      // the window's first RI-1 rows: r0 + w_lo + p
#pragma unroll
      for (int s = 0; s < NX; ++s)
#pragma unroll
        for (int p = 0; p < L::RI - 1; ++p) load_row(s, r0 + w_lo + p, win[s][p]);
    }
#ifdef BAND_ABLATE_NO_FMA
    if (n > 0) continue;
#endif
    for (int w0 = w_lo; w0 < w_hi; w0 += L::RI) {
#pragma unroll
      for (int step = 0; step < L::RI; ++step) {
        const int w = w0 + step;
#pragma unroll
        for (int s = 0; s < NX; ++s)
          load_row(s, r0 + L::RI - 1 + w, win[s][(step + L::RI - 1) % L::RI]);
#pragma unroll
        for (int s = 0; s < NB; ++s) {
          T coef[L::RI];
#pragma unroll
          for (int p = 0; p < L::RI; p += 4) lds4(st + s * BAND_ELEMS + w * L::T + il + p, coef + p);
#pragma unroll
          for (int p = 0; p < L::RI; ++p)
#pragma unroll
            for (int q = 0; q < L::RC; ++q)
              acc[SUM ? 0 : s][p][q] =
                  madd(coef[p], win[SUM ? s : 0][(step + p) % L::RI][q], acc[SUM ? 0 : s][p][q]);
        }
      }
    }
  }
  cp_async_wait<0>();

  if constexpr (L::G > 1) {
    // groups 1..G-1 leave their partial sums in shared memory; group 0
    // adds them to its own (in group order, so the sum is deterministic)
    constexpr int PART = NY * L::RI * L::RC;
    __syncthreads();
    if (group > 0) {
#pragma unroll
      for (int y = 0; y < NY; ++y)
#pragma unroll
        for (int p = 0; p < L::RI; ++p)
#pragma unroll
          for (int q = 0; q < L::RC; ++q)
            smem[(((group - 1) * PART) + (y * L::RI + p) * L::RC + q) * L::GROUP + gtid] =
                acc[y][p][q];
    }
    __syncthreads();
    if (group > 0) return;
    for (int g = 1; g < L::G; ++g) {
#pragma unroll
      for (int y = 0; y < NY; ++y)
#pragma unroll
        for (int p = 0; p < L::RI; ++p)
#pragma unroll
          for (int q = 0; q < L::RC; ++q)
            acc[y][p][q] += smem[(((g - 1) * PART) + (y * L::RI + p) * L::RC + q) * L::GROUP + gtid];
    }
  }

#pragma unroll
  for (int q = 0; q < L::RC; ++q) {
    const int c = c0 + (q / 4) * 4 * L::CG + cg * 4 + q % 4;
    if (c >= a.n_chains) continue;
    const size_t row = c * chain_stride + static_cast<size_t>(m) * n;
#pragma unroll
    for (int p = 0; p < L::RI; ++p) {
      const int i = i0 + il + p;
      if (i < n) {
#pragma unroll
        for (int y = 0; y < NY; ++y) a.ys[y][row + i] = acc[y][p][q];
      }
    }
  }
}

// Two chain tiles (T rows x CB chains, outputs a thread, groups splitting
// the diagonals, threads). Small: 16 x 32, 4 x 4, 4, 128; it fills the card
// at the slice's shape (C=128, n=397: 200 blocks) and serves float64 (the
// parity checks) at every shape. Large: 64 x 64, 8 x 8, 2, 128, two stages
// (the pair ops' two accumulator or window sets take ~230 registers, so
// fewer stages keep more blocks resident); a wide band (n=3169, b=160)
// re-stages less of x and of the bands per output. On an H100 each tile
// wins at its shape (PERF.md). Float32 runs Large from 2b+1 = 128
// (ops/cuda_band.LARGE_FROM_WIDTH).
using Small = Tile<4, 1, 4, 8, 4, 32, 3>;
using Large = Tile<8, 2, 8, 8, 2, 32, 2>;

template <typename T, class L, int NB, bool SUM>
int launch_tile(const Args<T>& a, cudaStream_t stream) {
  constexpr int NX = SUM ? NB : 1, NY = SUM ? 1 : NB;
  constexpr size_t staging = L::STAGES * NB * L::WK * L::T + NX * L::XR * L::XS;
  constexpr size_t partials = (L::G - 1) * NY * L::RI * L::RC * L::GROUP;
  constexpr size_t smem = sizeof(T) * (staging > partials ? staging : partials);
  static_assert(smem <= 232448, "shared memory per block");
  auto kernel = band_matvec_kernel<T, L, NB, SUM>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((a.n + L::T - 1) / L::T, (a.n_chains + L::CB - 1) / L::CB, a.n_mat);
  kernel<<<grid, L::THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

#ifndef BAND_ROW_STAGES
#define BAND_ROW_STAGES 4
#endif

// The row tile in the summation order of chain tile L, for at most NC
// chains: T = 16 rows, 128 threads (G x T of them accumulate), STAGES
// chunks in flight.
template <class L, int NC_, int STAGES_>
struct RowTile {
  static constexpr int G = L::G, WK = L::WK, WKG = L::WKG, RI = L::RI;  // L's order
  static constexpr int NC = NC_, STAGES = STAGES_, T = 16, THREADS = 128;
  // band row stride: odd, so that the two half-warps of a warp (groups
  // WK / 2 diagonals apart) read distinct banks
  static constexpr int TS = T + 1;
  static constexpr int XR = pow2_at_least(STAGES_ * WK + T);  // x ring rows
  static_assert((G == 2 || G == 4) && G * WKG == WK && G * T <= THREADS &&
                WK % (THREADS / T) == 0 && STAGES_ >= 2, "row tile shape");
};

template <typename T, class R, int NB, bool SUM>
__global__ void __launch_bounds__(R::THREADS) band_matvec_row_kernel(const Args<T> a) {
  constexpr int NX = SUM ? NB : 1, NY = SUM ? 1 : NB;
  constexpr int BAND_ELEMS = R::WK * R::TS, X_ELEMS = R::NC * R::XR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T* ring = smem + R::STAGES * NB * BAND_ELEMS;

  const int n = a.n, b = a.bandwidth, width = 2 * b + 1, nc = a.n_chains;
  const int m = blockIdx.y;
  const int i0 = blockIdx.x * R::T;
  const int tid = threadIdx.x;
  const int w_pad = (width + R::RI - 1) / R::RI * R::RI;
  const int n_chunks = (w_pad + R::WK - 1) / R::WK;
  const size_t chain_stride = static_cast<size_t>(a.n_mat) * n;
  const size_t band_base = static_cast<size_t>(m) * width * n;

  // Staging by all threads: thread (tid / T, tid % T) copies column tid % T
  // of every (THREADS / T)-th sheared diagonal of the chunk,
  //   bandS[w][t] = bands[m, w0+w, i0+w0+w-b+t],
  // and the chunk's new x rows of every chain,
  //   xS[c][r]    = xs[c, m, i0-b+r]   (r mod XR; chunk 0 brings rows
  //                 [0, T + WK), chunk k rows [T + k WK, T + (k+1) WK)).
  auto stage = [&](int chunk) {
#ifdef BAND_ABLATE_NO_STAGE
    if (n > 0) return;
#endif
    T* st = smem + (chunk % R::STAGES) * NB * BAND_ELEMS;
    const int w0 = chunk * R::WK;
    constexpr int W_STEP = R::THREADS / R::T;
    {
      const int t_col = tid % R::T;
      int w = w0 + tid / R::T;
      int j = i0 - b + w + t_col;
      size_t off = band_base + static_cast<size_t>(w) * n + j;
      T* dst = st + (tid / R::T) * R::TS + t_col;
#pragma unroll
      for (int it = 0; it < R::WK / W_STEP; ++it) {
        const bool ok = w < width && static_cast<unsigned>(j) < static_cast<unsigned>(n);
#pragma unroll
        for (int s = 0; s < NB; ++s)
          cp_async_zfill<sizeof(T)>(dst + s * BAND_ELEMS, a.bands[s] + (ok ? off : 0), ok);
        w += W_STEP;
        j += W_STEP;
        off += static_cast<size_t>(W_STEP) * (n + 1);
        dst += W_STEP * R::TS;
      }
    }
    const int r_lo = chunk == 0 ? 0 : R::T + w0;
    const int rows = chunk == 0 ? R::T + R::WK : R::WK;
    for (int e = tid; e < nc * rows; e += R::THREADS) {
      const int c = e / rows, r = r_lo + (e - c * rows);
      const int j = i0 - b + r;
      const bool ok = static_cast<unsigned>(j) < static_cast<unsigned>(n);
      const size_t off = ok ? c * chain_stride + static_cast<size_t>(m) * n + j : 0;
      T* dst = ring + c * R::XR + (r & (R::XR - 1));
#pragma unroll
      for (int s = 0; s < NX; ++s) cp_async_zfill<sizeof(T)>(dst + s * X_ELEMS, a.xs[s] + off, ok);
    }
  };

  // thread (g, t): group g's accumulators of output row t for every chain;
  // the two half-warps of a warp hold groups G / 2 apart
  const bool accumulates = tid < R::G * R::T;
  const int t = tid % R::T;
  const int g = ((tid / R::T) & 1) * (R::G / 2) + tid / 32;
  T acc[NY][R::NC];
#pragma unroll
  for (int y = 0; y < NY; ++y)
#pragma unroll
    for (int c = 0; c < R::NC; ++c) acc[y][c] = T(0);

#pragma unroll
  for (int k = 0; k < R::STAGES - 1; ++k) {
    if (k < n_chunks) stage(k);
    cp_async_commit();
  }
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    cp_async_wait<R::STAGES - 2>();
    __syncthreads();  // this chunk has landed; the slot refilled below is free
    const int ahead = chunk + R::STAGES - 1;
    if (ahead < n_chunks) stage(ahead);
    cp_async_commit();
#ifdef BAND_ABLATE_NO_FMA
    if (n > 0) continue;
#endif
    if (!accumulates) continue;
    const T* st = smem + (chunk % R::STAGES) * NB * BAND_ELEMS + t;
    // this group's diagonals of the chunk: w_lo + [0, n_w), as the chain
    // tile's group g takes them
    const int w_lo = g * R::WKG;
    const int n_w = min(R::WKG, w_pad - chunk * R::WK - w_lo);
    const int r0 = t + chunk * R::WK;  // x row of the chunk's diagonal 0
    auto term = [&](int w) {
      T x[NX][R::NC], coef[NB];
#pragma unroll
      for (int s = 0; s < NX; ++s)
#pragma unroll
        for (int c = 0; c < R::NC; ++c)
          x[s][c] = ring[s * X_ELEMS + c * R::XR + ((r0 + w) & (R::XR - 1))];
#pragma unroll
      for (int s = 0; s < NB; ++s) coef[s] = st[s * BAND_ELEMS + w * R::TS];
#pragma unroll
      for (int s = 0; s < NB; ++s)
#pragma unroll
        for (int c = 0; c < R::NC; ++c)
          acc[SUM ? 0 : s][c] = madd(coef[s], x[SUM ? s : 0][c], acc[SUM ? 0 : s][c]);
    };
    if (n_w == R::WKG) {
      // every chunk but the last: unrolled without a branch, so that the
      // shared-memory loads of all WKG diagonals issue ahead of the FMAs
#pragma unroll
      for (int k = 0; k < R::WKG; ++k) term(w_lo + k);
    } else {
      for (int k = 0; k < n_w; ++k) term(w_lo + k);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // groups 1..G-1 leave their sums in shared memory; group 0 adds them to
  // its own in group order, as the chain tile does
  constexpr int PART = NY * R::NC * R::T;
  if (accumulates && g > 0) {
#pragma unroll
    for (int y = 0; y < NY; ++y)
#pragma unroll
      for (int c = 0; c < R::NC; ++c) smem[(g - 1) * PART + (y * R::NC + c) * R::T + t] = acc[y][c];
  }
  __syncthreads();
  if (!accumulates || g > 0) return;
  for (int h = 1; h < R::G; ++h) {
#pragma unroll
    for (int y = 0; y < NY; ++y)
#pragma unroll
      for (int c = 0; c < R::NC; ++c) acc[y][c] += smem[(h - 1) * PART + (y * R::NC + c) * R::T + t];
  }
  const int i = i0 + t;
  if (i >= n) return;
#pragma unroll
  for (int c = 0; c < R::NC; ++c) {
    if (c >= nc) break;
#pragma unroll
    for (int y = 0; y < NY; ++y) a.ys[y][c * chain_stride + static_cast<size_t>(m) * n + i] = acc[y][c];
  }
}

template <typename T, class R, int NB, bool SUM>
int launch_rows(const Args<T>& a, cudaStream_t stream) {
  constexpr int NX = SUM ? NB : 1, NY = SUM ? 1 : NB;
  constexpr size_t staging = R::STAGES * NB * R::WK * R::TS + NX * R::NC * R::XR;
  constexpr size_t partials = (R::G - 1) * NY * R::NC * R::T;
  constexpr size_t smem = sizeof(T) * (staging > partials ? staging : partials);
  static_assert(smem <= 232448, "shared memory per block");
  auto kernel = band_matvec_row_kernel<T, R, NB, SUM>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((a.n + R::T - 1) / R::T, a.n_mat);
  kernel<<<grid, R::THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The row tile in L's order, instantiated for 1, 2, 4 and 8 chains.
template <typename T, class L, int NB, bool SUM>
int launch_row_tile(const Args<T>& a, cudaStream_t s) {
  constexpr int K = BAND_ROW_STAGES;
  if (a.n_chains <= 1) return launch_rows<T, RowTile<L, 1, K>, NB, SUM>(a, s);
  if (a.n_chains <= 2) return launch_rows<T, RowTile<L, 2, K>, NB, SUM>(a, s);
  if (a.n_chains <= 4) return launch_rows<T, RowTile<L, 4, K>, NB, SUM>(a, s);
  if (a.n_chains <= kRowMaxChains) return launch_rows<T, RowTile<L, 8, K>, NB, SUM>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tile of a launch, as ops/cuda_band.TILES numbers them; the Large
// order (chain or row) is float32's only.
enum TileCode { kChainSmall = 0, kChainLarge = 1, kRowSmall = 2, kRowLarge = 3 };

template <typename T, int NB, bool SUM>
int dispatch(const Args<T>& a, int tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case kChainSmall: return launch_tile<T, Small, NB, SUM>(a, s);
    case kRowSmall: return launch_row_tile<T, Small, NB, SUM>(a, s);
    default: break;
  }
  if constexpr (sizeof(T) == 4) {
    if (tile == kChainLarge) return launch_tile<T, Large, NB, SUM>(a, s);
    if (tile == kRowLarge) return launch_row_tile<T, Large, NB, SUM>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
Args<T> args(const void* b0, const void* b1, const void* x0, const void* x1, void* y0,
             void* y1, int n_chains, int n_mat, int n, int bandwidth) {
  return Args<T>{{static_cast<const T*>(b0), static_cast<const T*>(b1)},
                 {static_cast<const T*>(x0), static_cast<const T*>(x1)},
                 {static_cast<T*>(y0), static_cast<T*>(y1)},
                 n_chains, n_mat, n, bandwidth};
}

}  // namespace

// Plain C interface, loaded with ctypes (ops/cuda_band.py). Each takes the
// tile (TileCode) and returns the cudaGetLastError() code of its launch
// (0 = cudaSuccess; cudaErrorInvalidValue for a tile the dtype or the chain
// count does not take).
#define BAND_ENTRY_POINTS(SUFFIX, T)                                                    \
  extern "C" int band_matvec_##SUFFIX(const void* bands, const void* xs, void* ys,      \
                                      int n_chains, int n_mat, int n, int bandwidth,    \
                                      int tile, void* stream) {                         \
    return dispatch<T, 1, false>(                                                       \
        args<T>(bands, bands, xs, xs, ys, ys, n_chains, n_mat, n, bandwidth), tile,     \
        stream);                                                                        \
  }                                                                                     \
  extern "C" int band_matvec_pair_##SUFFIX(const void* bands_a, const void* bands_b,    \
                                           const void* xs, void* ys_a, void* ys_b,      \
                                           int n_chains, int n_mat, int n,              \
                                           int bandwidth, int tile, void* stream) {     \
    return dispatch<T, 2, false>(                                                       \
        args<T>(bands_a, bands_b, xs, xs, ys_a, ys_b, n_chains, n_mat, n, bandwidth),   \
        tile, stream);                                                                  \
  }                                                                                     \
  extern "C" int band_matvec_pair_t_##SUFFIX(const void* bands_a, const void* bands_b,  \
                                             const void* xs_a, const void* xs_b,        \
                                             void* ys, int n_chains, int n_mat, int n,  \
                                             int bandwidth, int tile, void* stream) {   \
    return dispatch<T, 2, true>(                                                        \
        args<T>(bands_a, bands_b, xs_a, xs_b, ys, ys, n_chains, n_mat, n, bandwidth),   \
        tile, stream);                                                                  \
  }

BAND_ENTRY_POINTS(f32, float)
BAND_ENTRY_POINTS(f64, double)
