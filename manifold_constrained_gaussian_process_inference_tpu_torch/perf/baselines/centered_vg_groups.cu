// The whitened FN value-and-grad's kernel as it stood before its chain
// groups were taken out (a block of G = 1, 2, 4 or 8 chains; the shipped
// csrc/centered_vg.cu takes one). Not built by the package: kept for
// perf/unroll_repro.py, which reproduces with it the float64 G = 1 and 2
// instances' wrong sums once the chunk loop is unrolled, and times it by
// G (the measurement that chose one chain a block; PERF.md, PR 11).
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
// the plain version this kernel is held to (chip_smoke.py's [vg]).
//
// Replaces no Pallas kernel: it replaces the JAX package's XLA-fused body
// of log_posterior_centered (manifold_constrained_gaussian_process_inference_tpu/
// ops/likelihood.py:386) under jax.value_and_grad as make_centered_whitened_vg
// (inference/whiten.py:527) builds it, which the port ran through autograd
// as ~140 small kernels, four of them K1's band launches (csrc/band_matvec.cu).
//
// What bounds it on an H100: six banded products of 2b+1 terms per output,
// 6 C D n (2b+1) multiply-adds (47 M at [slice]: C = 128, n = 397, b = 40,
// counting only the terms inside the grid; 1.4 us at the FP32 peak),
// against ~2.4 MB of operands (0.7 us at 3.35 TB/s): bound by operations
// (ops/centered_vg.bound_work). In practice a block streams the six band
// storages (1.5 MB at [slice], shared by every chain and so resident in L2)
// through its one SM, and each row's terms are a chain of dependent
// multiply-adds on loads from L2: latency, not the card's rates, sets its
// time.
//
// Design. A chain's whole state fits in shared memory: four (D, n) vectors
// (dx; e, then ebar; -g / beta_level; -h / beta_deriv), 12.7 KB in float32
// at n = 397. So a block owns a group of G chains (G = 1, 2, 4 or 8,
// chosen by ops/centered_vg.group_for) and runs all four stages with a
// barrier between them: no halo crosses blocks, no atomics. Each band
// coefficient is read once per block from L2 (coalesced: neighbouring
// threads take neighbouring rows, whose coefficients of one diagonal are
// neighbours in the column-indexed storage) and feeds the G chains'
// products from registers. Every product and sum runs in float64; a
// float32 chain's vectors are rounded to float32 only where they are
// stored (shared memory, the outputs), so its lp and gradient carry little
// more than the rounding of the float32 inputs (chip_smoke.py's [vg] holds
// them within twice the float32 plain version's own error). Against the
// loads' latency a thread loads a chunk of U terms' coefficients (16 in
// float32, 8 in float64) before it multiplies any, and the block runs 512
// threads, so that one or two outputs a thread cover [slice]'s 794. The threads take the outputs
// o = d n + i in a fixed stride whatever G is, each summing its terms
// k = -b..b in order by fused multiply-adds, and each stage's per-chain
// sums are reduced by a fixed tree (warp shuffles, then the warps in
// order) at the stage's barrier: a chain's bits do not depend on C, on G
// or on which chains share its block. The kernel launches on the caller's
// stream, allocates nothing and does not synchronise, so CUDA graphs
// capture it; centered_vg_init sets every instance's dynamic shared-memory
// limit once, at library load.
//
// The loop over a row's chunks stays rolled (#pragma unroll 1). With the
// loop over its terms left to nvcc (CUDA 12.8, -O3) to unroll, the float64
// instances for G = 1 and 2 summed a few rows wrongly (relative error ~1e-9
// in u = mphi dx at rows 21-23 of n = 41, b = 20; float32 and G = 4, 8 were
// right); rolled, every instance agrees with the plain version to 1e-15
// and with the others bit for bit (measured on the H100).
//
// Later work (ROADMAP): a block streams the bands of all n rows through one
// SM, so at C = 128 only C / G SMs work; row slabs of one chain group on a
// thread-block cluster, with the halos exchanged through distributed
// shared memory, would spread the bands over more SMs.

// Measurement variants, built only by perf/vg_timing.py --variants (which
// prepends the define to a copy of this source; the shipped library
// defines none):
//   CENTERED_VG_THREADS k    threads a block (512)
//   CENTERED_VG_PREFETCH u   terms a float32 thread prefetches (16; float64
//                            half as many)

#include <cuda_runtime.h>

#include <cstddef>

namespace {

#ifndef CENTERED_VG_THREADS
#define CENTERED_VG_THREADS 512
#endif
#ifndef CENTERED_VG_PREFETCH
#define CENTERED_VG_PREFETCH 16
#endif

constexpr int kThreads = CENTERED_VG_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 8;    // per chain: sse_0, sse_1, |g|^2, |h|^2, g_a, g_b, g_c, spare
constexpr int kParams = 8;  // per chain: a, b, c, sigma_0^2, sigma_1^2, spare
constexpr int kTheta = 3;
constexpr int kTail = 10;  // ops/centered_vg.TAIL
constexpr int kNPointers = 6, kNInts = 9;

enum Band { kMphi = 0, kGCt, kGKt, kGK, kMphiT, kGC };
enum Field { kXRef = 0, kRRef, kCE, kCGC, kMask };
enum Sum { kSse0 = 0, kSse1, kG2, kH2, kGa, kGb, kGc };

template <typename T>
struct VgArgs {
  const T* dpsi;     // (C, dim)
  const T* bands;    // (6, 2, 2b+1, n)
  const T* fields;   // (5, 2, n)
  const T* scalars;  // beta (3), nobs (2), sigma (2), lb (3), center tail (5)
  T* g_psi;          // (C, dim)
  T* lp;             // (C,)
  int n_chains, n, bandwidth, dim, sigma_sampled, theta_kind;
};

// Every computation runs in float64 (the storage type T is float32 or
// float64: a float32 chain's vectors, operands and outputs are stored in
// float32 and rounded once on store), and every rounding is explicit: an
// intrinsic is never contracted into a fused multiply-add, which the
// compiler may choose differently in each instance of the kernel's
// template, so a chain's bits would depend on its group G.
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

// The terms a thread prefetches at once: its loads in flight
template <typename T>
struct Prefetch {
  static constexpr int U = CENTERED_VG_PREFETCH;
};
template <>
struct Prefetch<double> {
  static constexpr int U = CENTERED_VG_PREFETCH / 2;
};

// acc[j][g] += sum_k band_j[b+k, i+k] * x_j[g][i+k] over 0 <= i+k < n, k
// ascending, for NB operators: ``diag[j]`` points at band_j[b, 0]
// (band_j[b+k, i+k] is diag[j][i + k (n+1)]); x_j is xs[0] for every j
// when NX is 1 (one vector, two operators), else xs[j]; a chain's vector is
// ``stride`` past the previous one's. The row's terms go in chunks of U:
// the chunk's coefficients are all loaded before its multiply-adds, so U
// loads a thread are in flight; a term past the row's last (k > khi)
// multiplies a zero coefficient by a zero. The chunk loop stays rolled (see
// the header).
template <typename T, int G, int NB, int NX>
__device__ __forceinline__ void band_rows(const T* const (&diag)[NB], const T* const (&xs)[NX],
                                          int stride, int i, int n, int b,
                                          double (&acc)[NB][G]) {
  constexpr int U = Prefetch<T>::U;
  const int klo = max(-b, -i), khi = min(b, n - 1 - i);
#pragma unroll 1  // see the header: unrolled by the compiler, float64 went wrong
  for (int k0 = klo; k0 <= khi; k0 += U) {
    T coef[NB][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const ptrdiff_t at = i + static_cast<ptrdiff_t>(k0 + u) * (n + 1);
#pragma unroll
      for (int j = 0; j < NB; ++j) coef[j][u] = k0 + u <= khi ? __ldg(diag[j] + at) : T(0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = k0 + u <= khi;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        T xv[NX];
#pragma unroll
        for (int x = 0; x < NX; ++x) xv[x] = ok ? xs[x][g * stride + i + k0 + u] : T(0);
#pragma unroll
        for (int j = 0; j < NB; ++j)
          acc[j][g] = fma_rn(coef[j][u], xv[NX == 1 ? 0 : j], acc[j][g]);
      }
    }
  }
}

// The per-chain sums v[g][j] of every thread, reduced by a fixed tree (each
// warp's by shuffles, then the warps' in order) into out[g kSums + j0 + j];
// ``partial`` (kWarps G NV values) is this reduction's own. Its barrier is
// also the stage's.
template <int G, int NV>
__device__ __forceinline__ void block_sums(double (&v)[G][NV], double* partial, double* out,
                                           int j0) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const double s = warp_sum(v[g][j]);
      if (lane == 0) partial[(warp * G + g) * NV + j] = s;
    }
  __syncthreads();
  if (tid < G * NV) {
    double t = partial[tid];
    for (int w = 1; w < kWarps; ++w) t = add(t, partial[w * G * NV + tid]);
    out[(tid / NV) * kSums + j0 + tid % NV] = t;
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads) centered_vg_kernel(const VgArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, b = a.bandwidth, nd = 2 * n, width = 2 * b + 1;
  // float64 first: the chains' parameters and sums, and each of the three
  // reductions' warp partials; then per chain g, in T: X (dx), E (e, then
  // ebar), GS (-g / beta_level), H (-h / beta_deriv), each (2, n)
  double* params = reinterpret_cast<double*>(smem_raw);
  double* totals = params + G * kParams;
  double* partial1 = totals + G * kSums;
  double* partial2 = partial1 + kWarps * G * 3;
  double* partial4 = partial2 + kWarps * G;
  const int stride = 4 * nd;
  T* X = reinterpret_cast<T*>(partial4 + kWarps * G * 3);
  T* E = X + nd;
  T* GS = X + 2 * nd;
  T* H = X + 3 * nd;

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * G;
  const int n_here = min(G, a.n_chains - c0);
  const T* s = a.scalars;
  const double beta_deriv = s[0], beta_level = s[1], beta_obs = s[2];
  const size_t bsz = static_cast<size_t>(width) * n;  // one (2b+1, n) storage
  auto band = [&](int which, int d) {
    return a.bands + (which * 2 + d) * bsz + static_cast<size_t>(b) * n;
  };
  auto field = [&](int which, int d, int i) -> double {
    return a.fields[(which * 2 + d) * n + i];
  };

  // the chains' theta and sigma^2, and dx into shared memory (the chains
  // past the launch's last hold zeros)
  if (tid < G) {
    double* p = params + tid * kParams;
    const T* row = a.dpsi + static_cast<size_t>(c0 + tid) * a.dim;
    for (int m = 0; m < kTheta; ++m) {
      const double z = tid < n_here ? add(s[kTail + m], row[nd + m]) : 0.0;
      p[m] = a.theta_kind == 1 ? add(s[7 + m], exp(z)) : z;
    }
    for (int d = 0; d < 2; ++d) {
      double sigma = s[5 + d];
      if (a.sigma_sampled) {
        const double ls = tid < n_here ? add(s[kTail + kTheta + d], row[nd + kTheta + d]) : 0.0;
        sigma = exp(clamp_keep_nan(ls, 15.0));
      }
      p[3 + d] = mul(sigma, sigma);
    }
  }
  for (int g = 0; g < G; ++g) {
    const T* row = a.dpsi + static_cast<size_t>(c0 + g) * a.dim;
    for (int o = tid; o < nd; o += kThreads) X[g * stride + o] = g < n_here ? row[o] : T(0);
  }
  __syncthreads();

  // stage 1: u = mphi dx, v = GC^T dx; e, -g / beta_level; the sums of r^2
  // (per state) and of g^2
  {
    double sums[G][3];
#pragma unroll
    for (int g = 0; g < G; ++g) sums[g][0] = sums[g][1] = sums[g][2] = 0.0;
    for (int o = tid; o < nd; o += kThreads) {
      const int d = o >= n, i = o - d * n;
      double uv[2][G];
#pragma unroll
      for (int g = 0; g < G; ++g) uv[0][g] = uv[1][g] = 0.0;
      const T* const diag[2] = {band(kMphi, d), band(kGCt, d)};
      const T* const xs[1] = {X + d * n};
      band_rows<T, G, 2, 1>(diag, xs, stride, i, n, b, uv);
      const double xr0 = field(kXRef, 0, i), xr1 = field(kXRef, 1, i);
      const double ce = field(kCE, d, i), cgc = field(kCGC, d, i);
      const double rref = field(kRRef, d, i), mask = field(kMask, d, i);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const double* p = params + g * kParams;
        const T* xg = X + g * stride;
        const double x0 = add(xr0, xg[i]), x1 = add(xr1, xg[n + i]);
        const double f = d == 0 ? mul(p[2], add(sub(x0, dvd(mul(mul(x0, x0), x0), 3.0)), x1))
                                : mul(dvd(-1.0, p[2]), add(sub(x0, p[0]), mul(p[1], x1)));
        E[g * stride + o] = T(sub(sub(f, ce), uv[0][g]));
        const double gg = add(cgc, uv[1][g]);
        GS[g * stride + o] = T(dvd(-gg, beta_level));
        const double r = mul(mask, add(xg[o], rref)), rr = mul(r, r);
        // (constant indices, so that the sums stay in registers)
        sums[g][0] = add(sums[g][0], d == 0 ? rr : 0.0);
        sums[g][1] = add(sums[g][1], d == 0 ? 0.0 : rr);
        sums[g][2] = add(sums[g][2], mul(gg, gg));
      }
    }
    block_sums<G, 3>(sums, partial1, totals, kSse0);
  }

  // stage 2: h = GK^T e; |h|^2, -h / beta_deriv
  {
    double sums[G][1];
#pragma unroll
    for (int g = 0; g < G; ++g) sums[g][0] = 0.0;
    for (int o = tid; o < nd; o += kThreads) {
      const int d = o >= n, i = o - d * n;
      double h[1][G];
#pragma unroll
      for (int g = 0; g < G; ++g) h[0][g] = 0.0;
      const T* const diag[1] = {band(kGKt, d)};
      const T* const xs[1] = {E + d * n};
      band_rows<T, G, 1, 1>(diag, xs, stride, i, n, b, h);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        sums[g][0] = add(sums[g][0], mul(h[0][g], h[0][g]));
        H[g * stride + o] = T(dvd(-h[0][g], beta_deriv));
      }
    }
    block_sums<G, 1>(sums, partial2, totals, kH2);
  }

  // stage 3: ebar = GK (-h / beta_deriv), into E
  for (int o = tid; o < nd; o += kThreads) {
    const int d = o >= n, i = o - d * n;
    double eb[1][G];
#pragma unroll
    for (int g = 0; g < G; ++g) eb[0][g] = 0.0;
    const T* const diag[1] = {band(kGK, d)};
    const T* const xs[1] = {H + d * n};
    band_rows<T, G, 1, 1>(diag, xs, stride, i, n, b, eb);
#pragma unroll
    for (int g = 0; g < G; ++g) E[g * stride + o] = T(eb[0][g]);
  }
  __syncthreads();

  // stage 4: the gradient in dx, and the theta gradient's sums
  {
    double sums[G][3];
#pragma unroll
    for (int g = 0; g < G; ++g) sums[g][0] = sums[g][1] = sums[g][2] = 0.0;
    for (int o = tid; o < nd; o += kThreads) {
      const int d = o >= n, i = o - d * n;
      double t[2][G];
#pragma unroll
      for (int g = 0; g < G; ++g) t[0][g] = t[1][g] = 0.0;
      const T* const diag[2] = {band(kMphiT, d), band(kGC, d)};
      const T* const xs[2] = {E + d * n, GS + d * n};
      band_rows<T, G, 2, 2>(diag, xs, stride, i, n, b, t);
      const double xr0 = field(kXRef, 0, i), xr1 = field(kXRef, 1, i);
      const double rref = field(kRRef, d, i), mask = field(kMask, d, i);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const double* p = params + g * kParams;
        const T* xg = X + g * stride;
        const double ta = p[0], tb = p[1], tc = p[2];
        const double x0 = add(xr0, xg[i]), x1 = add(xr1, xg[n + i]);
        const double e0 = E[g * stride + i], e1 = E[g * stride + n + i];
        double jx;
        if (d == 0) {
          jx = add(mul(e0, mul(tc, sub(1.0, mul(x0, x0)))), mul(e1, dvd(-1.0, tc)));
          sums[g][2] = add(sums[g][2],
                           mul(e0, add(sub(x0, dvd(mul(mul(x0, x0), x0), 3.0)), x1)));
        } else {
          jx = add(mul(e0, tc), mul(e1, dvd(-tb, tc)));
          sums[g][0] = add(sums[g][0], dvd(e1, tc));
          sums[g][1] = add(sums[g][1], mul(e1, dvd(-x1, tc)));
          sums[g][2] = add(sums[g][2],
                           mul(e1, dvd(add(sub(x0, ta), mul(tb, x1)), mul(tc, tc))));
        }
        const double r = mul(mask, add(xg[o], rref));
        if (g < n_here)
          a.g_psi[static_cast<size_t>(c0 + g) * a.dim + o] =
              T(sub(add(sub(jx, t[0][g]), t[1][g]), dvd(r, mul(p[3 + d], beta_obs))));
      }
    }
    block_sums<G, 3>(sums, partial4, totals, kGa);
  }
  __syncthreads();

  // one thread a chain: lp and the gradient's tail
  if (tid < n_here) {
    const int c = c0 + tid;
    const double* p = params + tid * kParams;
    const double* tot = totals + tid * kSums;
    const T* row = a.dpsi + static_cast<size_t>(c) * a.dim;
    T* grow = a.g_psi + static_cast<size_t>(c) * a.dim;
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
        const double z = add(s[kTail + m], row[nd + m]);
        zsum = add(zsum, z);
        grow[nd + m] = T(add(mul(g_theta[m], exp(z)), 1.0));
      }
      jac = zsum;
      has_jac = true;
    } else {
      for (int m = 0; m < kTheta; ++m) grow[nd + m] = T(g_theta[m]);
    }
    if (a.sigma_sampled) {
      double lsum = 0.0;
      for (int d = 0; d < 2; ++d) {
        const double ls = add(s[kTail + kTheta + d], row[nd + kTheta + d]);
        lsum = add(lsum, clamp_keep_nan(ls, 15.0));
        const bool inside = ls >= -15.0 && ls <= 15.0;
        grow[nd + kTheta + d] =
            T(inside ? add(dvd(sub(dvd(tot[kSse0 + d], p[3 + d]), s[3 + d]), beta_obs), 1.0)
                     : 0.0);
      }
      jac = has_jac ? add(jac, lsum) : lsum;
    }
    a.lp[c] = T(add(mul(-0.5, add(dvd(obs, beta_obs), quad)), jac));
  }
}

template <typename T, int G>
size_t shared_bytes(int n) {
  // ops/centered_vg.shared_bytes
  return sizeof(double) * (static_cast<size_t>(G) * (kSums + kParams) + kWarps * G * 7) +
         sizeof(T) * static_cast<size_t>(G) * 8 * n;
}

template <typename T, int G>
cudaError_t set_limit(int bytes) {
  return cudaFuncSetAttribute(centered_vg_kernel<T, G>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T>
int launch(const void* const* ptrs, const long long* ints, void* stream) {
  if (ints[7] != kNPointers || ints[8] != kNInts) return static_cast<int>(cudaErrorInvalidValue);
  VgArgs<T> a;
  a.dpsi = static_cast<const T*>(ptrs[0]);
  a.bands = static_cast<const T*>(ptrs[1]);
  a.fields = static_cast<const T*>(ptrs[2]);
  a.scalars = static_cast<const T*>(ptrs[3]);
  a.g_psi = static_cast<T*>(const_cast<void*>(ptrs[4]));
  a.lp = static_cast<T*>(const_cast<void*>(ptrs[5]));
  a.n_chains = static_cast<int>(ints[0]);
  a.n = static_cast<int>(ints[1]);
  a.bandwidth = static_cast<int>(ints[2]);
  a.dim = static_cast<int>(ints[3]);
  a.sigma_sampled = static_cast<int>(ints[4]);
  a.theta_kind = static_cast<int>(ints[5]);
  const int group = static_cast<int>(ints[6]);
  if (a.n_chains <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(kThreads);
  switch (group) {
#define CENTERED_VG_CASE(G)                                                              \
  case G:                                                                                \
    centered_vg_kernel<T, G>                                                             \
        <<<(a.n_chains + G - 1) / G, block, shared_bytes<T, G>(a.n), st>>>(a);           \
    break;
    CENTERED_VG_CASE(1)
    CENTERED_VG_CASE(2)
    CENTERED_VG_CASE(4)
    CENTERED_VG_CASE(8)
#undef CENTERED_VG_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Every instance may use the device's whole opt-in shared memory a block.
int centered_vg_init() {
  int dev = 0, bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const cudaError_t errs[] = {
      set_limit<float, 1>(bytes),  set_limit<float, 2>(bytes),  set_limit<float, 4>(bytes),
      set_limit<float, 8>(bytes),  set_limit<double, 1>(bytes), set_limit<double, 2>(bytes),
      set_limit<double, 4>(bytes), set_limit<double, 8>(bytes)};
  if (err != cudaSuccess) return static_cast<int>(err);
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return static_cast<int>(e);
  return 0;
}

int centered_vg_f32(const void* const* ptrs, const long long* ints, void* stream) {
  return launch<float>(ptrs, ints, stream);
}

int centered_vg_f64(const void* const* ptrs, const long long* ints, void* stream) {
  return launch<double>(ptrs, ints, stream);
}

}  // extern "C"
