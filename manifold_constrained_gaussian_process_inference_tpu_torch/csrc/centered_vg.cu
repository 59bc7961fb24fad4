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
// time. The loads are a third of it in float32; the rest is the chain and
// each term's conversion to float64 (perf/vg_timing.py --probe).
//
// Design. A chain's whole state fits in shared memory: four (D, n) vectors
// (dx; e, then ebar; -g / beta_level; -h / beta_deriv), 12.7 KB in float32
// at n = 397. So a block owns one chain and runs all four stages with a
// barrier between them: no halo crosses blocks, no atomics. (Blocks of 2,
// 4 and 8 chains, each band coefficient loaded once for all of them, were
// slower at every measured shape: a block streams all six storages whatever
// its chains, so more chains a block only take SMs away; PERF.md, PR 11.)
// The band coefficients are read from L2 (coalesced: neighbouring threads
// take neighbouring rows, whose coefficients of one diagonal are neighbours
// in the column-indexed storage). Every product and sum runs in float64; a
// float32 chain's vectors are rounded to float32 only where they are
// stored (shared memory, the outputs), so its lp and gradient carry little
// more than the rounding of the float32 inputs (chip_smoke.py's [vg] holds
// them within twice the float32 plain version's own error). Against the
// loads' latency a thread loads a chunk of U terms' coefficients (16 in
// float32, 8 in float64) before it multiplies any, and the block runs 512
// threads, so that one or two outputs a thread cover [slice]'s 794. The
// threads take the outputs o = d n + i in a fixed stride, each summing its
// terms k = -b..b in order by fused multiply-adds, and each stage's sums
// are reduced by a fixed tree (warp shuffles, then the warps in order) at
// the stage's barrier: a chain's bits do not depend on C or on which
// chains share the launch. The kernel launches on the caller's stream,
// allocates nothing and does not synchronise, so CUDA graphs capture it;
// centered_vg_init sets both instances' dynamic shared-memory limit once,
// at library load.
//
// The chunk loop carries no unroll pragma. An earlier version held it under
// `#pragma unroll 1` after one float64 check had failed, but that pragma
// changed no instruction: every instance's SASS is the same with and
// without it, and both builds agree with the plain version to 1.3e-15
// (perf/unroll_repro.py, which keeps that version as a baseline).
//
// Later work (ROADMAP): a block streams the bands of all n rows through one
// SM; row slabs of one chain on a thread-block cluster, with the halos
// exchanged through distributed shared memory, would spread the bands over
// more SMs.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 8;    // sse_0, sse_1, |g|^2, |h|^2, g_a, g_b, g_c, spare
constexpr int kParams = 8;  // a, b, c, sigma_0^2, sigma_1^2, spare
constexpr int kTheta = 3;
constexpr int kTail = 10;  // ops/centered_vg.TAIL
constexpr int kNPointers = 6, kNInts = 8;

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
// template, so the two dtypes' instances would not share one order.
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
  static constexpr int U = 16;
};
template <>
struct Prefetch<double> {
  static constexpr int U = 8;
};

// acc[j] += sum_k band_j[b+k, i+k] * x_j[i+k] over 0 <= i+k < n, k
// ascending, for NB operators: ``diag[j]`` points at band_j[b, 0]
// (band_j[b+k, i+k] is diag[j][i + k (n+1)]); x_j is xs[0] for every j
// when NX is 1 (one vector, two operators), else xs[j]. The row's terms go
// in chunks of U: the chunk's coefficients are all loaded before its
// multiply-adds, so U loads a thread are in flight; a term past the row's
// last (k > khi) multiplies a zero coefficient by a zero.
template <typename T, int NB, int NX>
__device__ __forceinline__ void band_rows(const T* const (&diag)[NB], const T* const (&xs)[NX],
                                          int i, int n, int b, double (&acc)[NB]) {
  constexpr int U = Prefetch<T>::U;
  const int klo = max(-b, -i), khi = min(b, n - 1 - i);
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
      T xv[NX];
#pragma unroll
      for (int x = 0; x < NX; ++x) xv[x] = ok ? xs[x][i + k0 + u] : T(0);
#pragma unroll
      for (int j = 0; j < NB; ++j) acc[j] = fma_rn(coef[j][u], xv[NX == 1 ? 0 : j], acc[j]);
    }
  }
}

// The chain's sums v[j] of every thread, reduced by a fixed tree (each
// warp's by shuffles, then the warps' in order) into out[j0 + j];
// ``partial`` (kWarps NV values) is this reduction's own. Its barrier is
// also the stage's.
template <int NV>
__device__ __forceinline__ void block_sums(double (&v)[NV], double* partial, double* out,
                                           int j0) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const double s = warp_sum(v[j]);
    if (lane == 0) partial[warp * NV + j] = s;
  }
  __syncthreads();
  if (tid < NV) {
    double t = partial[tid];
    for (int w = 1; w < kWarps; ++w) t = add(t, partial[w * NV + tid]);
    out[j0 + tid] = t;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) centered_vg_kernel(const VgArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, b = a.bandwidth, nd = 2 * n, width = 2 * b + 1;
  // float64 first: the chain's parameters and sums, and each of the three
  // reductions' warp partials; then in T: X (dx), E (e, then ebar), GS
  // (-g / beta_level), H (-h / beta_deriv), each (2, n)
  double* params = reinterpret_cast<double*>(smem_raw);
  double* totals = params + kParams;
  double* partial1 = totals + kSums;
  double* partial2 = partial1 + kWarps * 3;
  double* partial4 = partial2 + kWarps;
  T* X = reinterpret_cast<T*>(partial4 + kWarps * 3);
  T* E = X + nd;
  T* GS = X + 2 * nd;
  T* H = X + 3 * nd;

  const int tid = threadIdx.x;
  const int c = blockIdx.x;
  const T* s = a.scalars;
  const T* row = a.dpsi + static_cast<size_t>(c) * a.dim;
  T* grow = a.g_psi + static_cast<size_t>(c) * a.dim;
  const double beta_deriv = s[0], beta_level = s[1], beta_obs = s[2];
  const size_t bsz = static_cast<size_t>(width) * n;  // one (2b+1, n) storage
  auto band = [&](int which, int d) {
    return a.bands + (which * 2 + d) * bsz + static_cast<size_t>(b) * n;
  };
  auto field = [&](int which, int d, int i) -> double {
    return a.fields[(which * 2 + d) * n + i];
  };

  // the chain's theta and sigma^2, and dx into shared memory
  if (tid == 0) {
    for (int m = 0; m < kTheta; ++m) {
      const double z = add(s[kTail + m], row[nd + m]);
      params[m] = a.theta_kind == 1 ? add(s[7 + m], exp(z)) : z;
    }
    for (int d = 0; d < 2; ++d) {
      double sigma = s[5 + d];
      if (a.sigma_sampled)
        sigma = exp(clamp_keep_nan(add(s[kTail + kTheta + d], row[nd + kTheta + d]), 15.0));
      params[3 + d] = mul(sigma, sigma);
    }
  }
  for (int o = tid; o < nd; o += kThreads) X[o] = row[o];
  __syncthreads();
  const double ta = params[0], tb = params[1], tc = params[2];

  // stage 1: u = mphi dx, v = GC^T dx; e, -g / beta_level; the sums of r^2
  // (per state) and of g^2
  {
    double sums[3] = {0.0, 0.0, 0.0};
    for (int o = tid; o < nd; o += kThreads) {
      const int d = o >= n, i = o - d * n;
      double uv[2] = {0.0, 0.0};
      const T* const diag[2] = {band(kMphi, d), band(kGCt, d)};
      const T* const xs[1] = {X + d * n};
      band_rows<T, 2, 1>(diag, xs, i, n, b, uv);
      const double x0 = add(field(kXRef, 0, i), X[i]), x1 = add(field(kXRef, 1, i), X[n + i]);
      const double f = d == 0 ? mul(tc, add(sub(x0, dvd(mul(mul(x0, x0), x0), 3.0)), x1))
                              : mul(dvd(-1.0, tc), add(sub(x0, ta), mul(tb, x1)));
      E[o] = T(sub(sub(f, field(kCE, d, i)), uv[0]));
      const double gg = add(field(kCGC, d, i), uv[1]);
      GS[o] = T(dvd(-gg, beta_level));
      const double r = mul(field(kMask, d, i), add(X[o], field(kRRef, d, i))), rr = mul(r, r);
      // (constant indices, so that the sums stay in registers)
      sums[0] = add(sums[0], d == 0 ? rr : 0.0);
      sums[1] = add(sums[1], d == 0 ? 0.0 : rr);
      sums[2] = add(sums[2], mul(gg, gg));
    }
    block_sums<3>(sums, partial1, totals, kSse0);
  }

  // stage 2: h = GK^T e; |h|^2, -h / beta_deriv
  {
    double sums[1] = {0.0};
    for (int o = tid; o < nd; o += kThreads) {
      const int d = o >= n, i = o - d * n;
      double h[1] = {0.0};
      const T* const diag[1] = {band(kGKt, d)};
      const T* const xs[1] = {E + d * n};
      band_rows<T, 1, 1>(diag, xs, i, n, b, h);
      sums[0] = add(sums[0], mul(h[0], h[0]));
      H[o] = T(dvd(-h[0], beta_deriv));
    }
    block_sums<1>(sums, partial2, totals, kH2);
  }

  // stage 3: ebar = GK (-h / beta_deriv), into E
  for (int o = tid; o < nd; o += kThreads) {
    const int d = o >= n, i = o - d * n;
    double eb[1] = {0.0};
    const T* const diag[1] = {band(kGK, d)};
    const T* const xs[1] = {H + d * n};
    band_rows<T, 1, 1>(diag, xs, i, n, b, eb);
    E[o] = T(eb[0]);
  }
  __syncthreads();

  // stage 4: the gradient in dx, and the theta gradient's sums
  {
    double sums[3] = {0.0, 0.0, 0.0};
    for (int o = tid; o < nd; o += kThreads) {
      const int d = o >= n, i = o - d * n;
      double t[2] = {0.0, 0.0};
      const T* const diag[2] = {band(kMphiT, d), band(kGC, d)};
      const T* const xs[2] = {E + d * n, GS + d * n};
      band_rows<T, 2, 2>(diag, xs, i, n, b, t);
      const double x0 = add(field(kXRef, 0, i), X[i]), x1 = add(field(kXRef, 1, i), X[n + i]);
      const double e0 = E[i], e1 = E[n + i];
      double jx;
      if (d == 0) {
        jx = add(mul(e0, mul(tc, sub(1.0, mul(x0, x0)))), mul(e1, dvd(-1.0, tc)));
        sums[2] = add(sums[2], mul(e0, add(sub(x0, dvd(mul(mul(x0, x0), x0), 3.0)), x1)));
      } else {
        jx = add(mul(e0, tc), mul(e1, dvd(-tb, tc)));
        sums[0] = add(sums[0], dvd(e1, tc));
        sums[1] = add(sums[1], mul(e1, dvd(-x1, tc)));
        sums[2] = add(sums[2], mul(e1, dvd(add(sub(x0, ta), mul(tb, x1)), mul(tc, tc))));
      }
      const double r = mul(field(kMask, d, i), add(X[o], field(kRRef, d, i)));
      grow[o] = T(sub(add(sub(jx, t[0]), t[1]), dvd(r, mul(params[3 + d], beta_obs))));
    }
    block_sums<3>(sums, partial4, totals, kGa);
  }
  __syncthreads();

  // one thread: lp and the gradient's tail
  if (tid == 0) {
    const double* tot = totals;
    const double log2pi = 1.8378770664093453;
    double obs = 0.0;
    for (int d = 0; d < 2; ++d)
      obs = add(obs, add(dvd(tot[kSse0 + d], params[3 + d]),
                         mul(s[3 + d], add(log2pi, log(params[3 + d])))));
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
            T(inside ? add(dvd(sub(dvd(tot[kSse0 + d], params[3 + d]), s[3 + d]), beta_obs), 1.0)
                     : 0.0);
      }
      jac = has_jac ? add(jac, lsum) : lsum;
    }
    a.lp[c] = T(add(mul(-0.5, add(dvd(obs, beta_obs), quad)), jac));
  }
}

template <typename T>
size_t shared_bytes(int n) {
  // ops/centered_vg.shared_bytes
  return sizeof(double) * (kSums + kParams + kWarps * 7) + sizeof(T) * 8 * static_cast<size_t>(n);
}

template <typename T>
int launch(const void* const* ptrs, const long long* ints, void* stream) {
  if (ints[6] != kNPointers || ints[7] != kNInts) return static_cast<int>(cudaErrorInvalidValue);
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
  if (a.n_chains <= 0) return 0;
  centered_vg_kernel<T><<<a.n_chains, kThreads, shared_bytes<T>(a.n),
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Both instances may use the device's whole opt-in shared memory a block.
int centered_vg_init() {
  int dev = 0, bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(centered_vg_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(centered_vg_kernel<double>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return static_cast<int>(err);
}

int centered_vg_f32(const void* const* ptrs, const long long* ints, void* stream) {
  return launch<float>(ptrs, ints, stream);
}

int centered_vg_f64(const void* const* ptrs, const long long* ints, void* stream) {
  return launch<double>(ptrs, ints, stream);
}

}  // extern "C"
