// Stacked banded matvec in diagonal band storage, with a native chain axis.
//
//   y[c, m, i] = sum_{k=-b..b} bands[m, b+k, i+k] * xs[c, m, i+k]
//
// with zero terms where i+k lies outside [0, n). Row b+k of the band
// storage holds the diagonal with offset k, indexed by its COLUMN i+k
// (ops/band.py dense_to_band_storage). The bands (M, W=2b+1, n) are shared
// by all C chains; xs and y are (C, M, n), contiguous.
//
// Replaces the Pallas TPU kernel
// manifold_constrained_gaussian_process_inference_tpu/ops/pallas_band.py
// (_band_matvec_kernel, launched by _pallas_band_matvec_impl), which ran one
// (M, n) problem in VMEM per call, unrolling the W diagonals as lane rolls
// with edge masks; the JAX package ran it under vmap over chains, which
// serialises the kernel grid. Here the chain axis is a grid axis.
//
// What bounds it on an H100: at the main path's shapes (C=128, M=2, b=40,
// n=397) one call reads C*M*n*4 ~ 406 KB of x and M*W*n*4 ~ 257 KB of bands
// (float32) and does C*M*n*W ~ 8.2 M multiply-adds: a few microseconds of
// either bandwidth or FMA throughput, so the call is bound by launch latency.
// The design is the simple one: one thread per output (c, m, i); each block
// stages the x window it needs, x[c, m, i0-b .. i0+T+b), in shared memory
// (zero-filled outside [0, n), which also realises the edge masks), and
// reads band[m, b+k, i+k] coalesced in i for each k. The bands stay in L2
// across chains. wgmma and TMA do not help a banded stencil. Fusing the
// three calls of one likelihood evaluation and giving each thread several
// outputs are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;  // outputs (threads) per block

template <typename T>
__global__ void band_matvec_kernel(const T* __restrict__ bands,
                                   const T* __restrict__ xs,
                                   T* __restrict__ ys, int n_mat, int n,
                                   int bandwidth) {
  extern __shared__ unsigned char smem_raw[];
  T* x_tile = reinterpret_cast<T*>(smem_raw);

  const int m = blockIdx.y;
  const int c = blockIdx.z;
  const int i0 = blockIdx.x * kTile;
  const int width = 2 * bandwidth + 1;
  const size_t row = (static_cast<size_t>(c) * n_mat + m) * n;
  const T* x = xs + row;

  // x_tile[s] = x[i0 - b + s], zero outside [0, n)
  const int span = kTile + 2 * bandwidth;
  for (int s = threadIdx.x; s < span; s += blockDim.x) {
    const int j = i0 - bandwidth + s;
    x_tile[s] = (j >= 0 && j < n) ? x[j] : T(0);
  }
  __syncthreads();

  const int i = i0 + threadIdx.x;
  if (i >= n) return;
  const T* band = bands + static_cast<size_t>(m) * width * n;
  T acc = T(0);
  for (int w = 0; w < width; ++w) {  // w = b + k
    const int j = i + w - bandwidth;  // column i + k
    if (j >= 0 && j < n) {
      acc += band[static_cast<size_t>(w) * n + j] * x_tile[threadIdx.x + w];
    }
  }
  ys[row + i] = acc;
}

template <typename T>
int launch(const void* bands, const void* xs, void* ys, int n_chains,
           int n_mat, int n, int bandwidth, void* stream) {
  const dim3 grid((n + kTile - 1) / kTile, n_mat, n_chains);
  const size_t smem = sizeof(T) * (kTile + 2 * bandwidth);
  band_matvec_kernel<T><<<grid, kTile, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(bands), static_cast<const T*>(xs),
      static_cast<T*>(ys), n_mat, n, bandwidth);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes (ops/cuda_band.py). Returns the
// cudaGetLastError() code of the launch (0 = cudaSuccess).
extern "C" int band_matvec_f32(const void* bands, const void* xs, void* ys,
                               int n_chains, int n_mat, int n, int bandwidth,
                               void* stream) {
  return launch<float>(bands, xs, ys, n_chains, n_mat, n, bandwidth, stream);
}

extern "C" int band_matvec_f64(const void* bands, const void* xs, void* ys,
                               int n_chains, int n_mat, int n, int bandwidth,
                               void* stream) {
  return launch<double>(bands, xs, ys, n_chains, n_mat, n, bandwidth, stream);
}
