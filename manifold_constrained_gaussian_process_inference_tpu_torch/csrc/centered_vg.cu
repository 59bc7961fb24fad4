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
// of the prepared tiles, the tiling (``tiling``: the arithmetic of the
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
// counting only the terms inside the grid; 1.4 us at 67 TFLOP/s, the
// float64 peak of the FP64 tensor cores that run them here), against
// ~2.4 MB of operands (0.7 us at 3.35 TB/s): bound by operations
// (ops/centered_vg.bound_work). Every product is the same banded operator
// times a group of chains' vectors, so a stage is a matrix product with the
// chains as its N. What bounds this design is not that count but:
// - the DMMAs a block runs: its slab's row tiles x 2 states x 6 operators
//   x 12 k steps at b = 40 (1.19x the band's terms), one N tile each;
// - the prepared tiles each block streams from L2 (every cluster reads
//   every operator's, a block its slab's: 56 MiB a launch at [slice] in
//   float32);
// - the latency of a sequence that no block can shorten: the fill of the
//   chains' vectors, four stages each ending in a halo exchange and a
//   cluster barrier, and rank 0's sums.
//
// Design: a thread-block cluster serves a group of Cg chains, and its S
// blocks split the grid's rows; each stage's products run as sm_90's
// m16n8k8 DMMAs (float64 in, float64 sums) over a prepared copy of the
// operators. The earlier designs (perf/baselines/centered_vg_pr11.cu, one
// block per chain; centered_vg_pr12.cu, the same cluster with each thread's
// scalar multiply-adds) loaded and converted every float32 coefficient
// once per chain group and ran one dependent chain of float64 FMAs per
// output on ~4 warps a block. Here:
//
// - Rows over a cluster. Block `rank` owns the slab of grid rows
//   [rank L, min(n, (rank + 1) L)), both states of each (stages 1 and 4
//   couple x[i] with x[n+i]), L a whole number of 16-row tiles (a DMMA's m).
//   S depends on n alone: 1 where one block has a warp for each of the
//   grid's (tile, state) items (n <= 96: more blocks would add barriers
//   and halo exchanges, not warps), else the least number of slabs up to
//   kMaxCluster = 5: at one block an SM the H100 ran only 15 clusters of 7
//   or 8 at once (7 of 13), so the 16th of C = 128's (Cg = 8) waited for a
//   whole launch's time. A slab may be shorter than b: a block's halo of b
//   rows each side then comes from every block within reach (ceil(b / L)
//   each side).
// - The prepared tiles (ops/centered_vg.prepare_tiles, once per target).
//   Each operator of each state is cut into 16-row tiles over each tile's
//   window of columns, its first row less b to its last plus b, in k steps
//   of 8: 12 steps at b = 40. A k step is 128 values in the order of the
//   DMMA's A fragments (a lane's four together), zero outside the band and
//   the grid, in the storages' type: a float32 instance reads 16 bytes a
//   lane and converts them exactly to float64 as it loads them, which
//   halves the bytes from L2 and took no measurable time; a float64
//   instance reads 32. Six operators are stored, not three read both ways:
//   a transpose's A fragments are another layout of the same values, and a
//   block would stream as many bytes either way.
// - A block's items are the (tile, state) pairs of its slab, a warp each
//   (at most 12 warps, which then take turns). Each warp streams its
//   items' tiles, stage after stage, through a ring of slots of 2 KiB (4 k
//   steps of one operator in float32, 2 in float64; 6 slots a warp, fewer
//   where the block's rings would pass 96 KiB or crowd out the chains, at
//   least 2): its lane 0 issues one bulk
//   copy of the Tensor Memory Accelerator a slot under the slot's mbarrier
//   and refills a slot as soon as the warp has read it, so the next
//   stage's tiles are in flight through the barriers between the stages.
// - The chains' vectors are staged in shared memory in float64 (a float32
//   instance's values are its float32 roundings, converted once), each over
//   its slab's tile windows: X (dx, then -h / beta_deriv), E (e, then ebar),
//   GS (-g / beta_level). A vector's stride is 4 modulo 16 doubles, so a
//   warp's B fragment (8 chains x 4 consecutive rows, twice) reads 16
//   distinct banks a half-warp. dx comes from dpsi, halo and all; a stage
//   writes its outputs into its own block, and after a block barrier
//   pushes the rows that another block's halo holds into that block
//   (distributed shared memory, consecutive rows on consecutive lanes);
//   the cluster barrier after the stage publishes them. A vector's halo is
//   next written only after a barrier that follows every read of it; the
//   first push waits on an arrival made when every block's E and GS were
//   zeroed. A cluster of one block uses the block's own barriers.
// - A k step multiplies each of the stage's operators (two in stages 1 and
//   4) by every N tile of 8 chains of the cluster (Cg / 8 of them; below 8
//   chains one N tile whose missing chains are zeros), so an A fragment
//   serves Cg chains. A stage's epilogue runs on the accumulators as they
//   are: a lane holds rows g and g + 8 of its tile for chains 2t and 2t+1
//   of each N tile; every product and sum in float64, rounded to the
//   storage type where the earlier designs round (E, GS, H, g_psi). The
//   quotients and reciprocals a chain's rows share (-1/c, -b/c, c^2, 1/c,
//   1/c^2, 1/(sigma_d^2 beta_obs)) and 1/beta_deriv, 1/beta_level are
//   computed once, and a row multiplies by them where it divided.
// - The order of every sum depends on (n, b) alone: a row's terms are the
//   DMMAs' over its tile's window in ascending k steps (another order than
//   the earlier designs' ascending __fma_rn chain, so the float32 bits of
//   the x block differ from theirs), and a chain's sums (lp, the theta and
//   log-sigma gradients) take rows g and g + 8 of a tile into entry 8 q + g
//   of its lane, each block's entries reduced by a fixed tree (a warp per
//   chain: lanes take every 32nd entry, then shuffles), every block pushes
//   its sums into rank 0, and rank 0 adds the S blocks' in rank order. So a
//   chain's bits do not depend on C, Cg or which chains share its launch.
//
// Measured on the H100 (perf/vg_timing.py; PERF.md): [slice] 0.028 ms a
// launch in float32, 0.032 in float64 (the scalar cluster design,
// perf/baselines/centered_vg_pr12.cu, 0.051, 0.056), 16 clusters of 5 in
// one wave. A block runs 26 us, first stamp to last: ring
// set-up 1.8, fill 2.8, parameters 1.1, stage 1 5.8, stages 2-4 2.7, 2.7,
// 3.6, reductions, barriers and rank 0's sums ~7. Its DMMAs are a few us
// of that and rings of 6 slots read no faster than 4, so the launch is
// bound by the latency of its sequence (the set-up, four stages each
// ending in a barrier, the sums), not by the DMMA rate nor by the tiles'
// bytes. [resume] (S = 1, one chain a block) 0.0147.
//
// The launch (cudaLaunchKernelEx with the cluster dimension) goes on the
// caller's stream, allocates nothing and does not synchronise, so CUDA
// graphs, a WHILE node's body among them, capture it; centered_vg_init sets
// every instance's dynamic shared-memory limit once, at library load, and
// centered_vg_max_clusters answers how many clusters of a tiling the card
// runs at once (cudaOccupancyMaxActiveClusters; 0: it cannot run at all).
// centered_vg_prepare_<t> writes the prepared tiles.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kTileRows = 16;     // a DMMA's m: rows of an operator tile
constexpr int kStep = 8;          // a DMMA's k: columns of a k step
constexpr int kChainTile = 8;     // a DMMA's n: chains of an N tile
constexpr int kMaxNTiles = 4;     // N tiles a cluster at most
constexpr int kMaxWarps = 12;
constexpr int kMaxThreads = 32 * kMaxWarps;  // threads a block at most
constexpr int kMaxCluster = 5;   // a cluster's blocks at most (ops/centered_vg.WAVE_CLUSTER)
constexpr int kFragElems = 128;   // a prepared k step of one operator: 16 x 8, A-fragment order
constexpr int kSlots = 6;         // a warp's ring of prepared tiles: at most kSlots slots,
constexpr int kRingBytes = 98304; // of kSlotBytes each, kRingBytes a block at most
constexpr int kSlotBytes = 2048;  // a slot: one operator's k steps, 4 in float32, 2 in float64
constexpr int kMaxShared = 232448;  // a block's shared memory at most (the H100's opt-in)
constexpr int kFill = 16;         // loads a thread keeps in flight filling X
constexpr int kSums = 8;    // sse_0, sse_1, |g|^2, |h|^2, g_a, g_b, g_c, spare
constexpr int kParams = 12;  // a, b, c, sigma_0^2, sigma_1^2, -1/c, -b/c, c^2, 1/c, 1/c^2,
                             // 1/(sigma_0^2 beta_obs), 1/(sigma_1^2 beta_obs)
constexpr double kThird = 1.0 / 3.0;
constexpr int kLanes = 4;   // the partial lanes a stage keeps per chain
constexpr int kVectors = 3; // X (then H), E, GS
constexpr int kTheta = 3;
constexpr int kTail = 10;  // ops/centered_vg.TAIL
constexpr int kNPointers = 6, kNInts = 13;

enum Band { kMphi = 0, kGCt, kGKt, kGK, kMphiT, kGC };
enum Field { kXRef = 0, kRRef, kCE, kCGC, kMask };
enum Sum { kSse0 = 0, kSse1, kG2, kH2, kGa, kGb, kGc };
enum Vector { kXH = 0, kE, kGS };

// The operators of stage s (0-based) in the order of a k step's slots
__host__ __device__ __forceinline__ int stage_ops(int s) { return s == 0 || s == 3 ? 2 : 1; }
__device__ __forceinline__ int stage_op(int s, int op) {
  return s == 0 ? (op == 0 ? kMphi : kGCt) : s == 1 ? kGKt : s == 2 ? kGK : (op == 0 ? kMphiT : kGC);
}

template <typename T>
struct VgArgs {
  const T* dpsi;        // (C, dim)
  const T* tiles;       // (6, 2, row tiles, ksteps_of(b), kFragElems): ops/centered_vg.prepare_tiles
  const T* fields;      // (5, 2, n)
  const T* scalars;     // beta (3), nobs (2), sigma (2), lb (3), center tail (5)
  T* g_psi;             // (C, dim)
  T* lp;                // (C,)
  int n_chains, n, bandwidth, dim, sigma_sampled, theta_kind;
  int cluster, slab, chains;  // S, L, Cg (ops/centered_vg.tiling)
};

// Every computation runs in float64 (the storage type T is float32 or
// float64: a float32 chain's vectors, operands and outputs are stored in
// float32 and rounded once on store), and every rounding is explicit: an
// intrinsic is never contracted into a fused multiply-add, which the
// compiler may choose differently in each instance of the kernel's
// template, so the instances would not share one order.
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double dvd(double a, double b) { return __ddiv_rn(a, b); }

__device__ __forceinline__ double clamp_keep_nan(double v, double lim) {
  return v < -lim ? -lim : (v > lim ? lim : v);
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

// Copy `bytes` from global memory into shared memory with the Tensor Memory
// Accelerator, arming `bar` with them; the barrier's phase completes when
// they have landed.
__device__ __forceinline__ void stage_copy(unsigned dst, const void* src, unsigned bytes,
                                           unsigned bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
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

// A lane's A fragment of a prepared k step (its four values at 4 lane, in
// the order of a), converted exactly to float64
__device__ __forceinline__ void load_frag(const float* f, double (&a)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(f);
  a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w;
}
__device__ __forceinline__ void load_frag(const double* f, double (&a)[4]) {
  const double2 lo = reinterpret_cast<const double2*>(f)[0];
  const double2 hi = reinterpret_cast<const double2*>(f)[1];
  a[0] = lo.x, a[1] = lo.y, a[2] = hi.x, a[3] = hi.y;
}

// The k steps of a row tile's window: its 16 rows and b columns each side
__host__ __device__ __forceinline__ int ksteps_of(int b) {
  return (kTileRows + 2 * b + kStep - 1) / kStep;
}

// The shared memory of a block, in doubles per chain: the chain's
// parameters and sums, the cluster's blocks' sums (rank 0 gathers them),
// kLanes partial lanes of slab / 2 entries, and the kVectors staged
// vectors of both states, each over the slab's tile windows (position p is
// grid row lo - b + p), at a stride of 4 modulo 16
__host__ __device__ __forceinline__ int width_of(int slab, int b) {
  return slab - kTileRows + kStep * ksteps_of(b);
}
__host__ __device__ __forceinline__ int stride_of(int slab, int b) {
  const int w = width_of(slab, b);
  return w + ((4 - w) % 16 + 16) % 16;
}
__host__ __device__ __forceinline__ int groups_of(int slab) { return slab / 2; }
__host__ __device__ __forceinline__ size_t chain_doubles(int slab, int b) {
  // ops/centered_vg.chain_bytes
  return kParams + kSums + kMaxCluster * (kSums - 1) + static_cast<size_t>(kLanes) * groups_of(slab) +
         static_cast<size_t>(kVectors) * 2 * stride_of(slab, b);
}
// A warp per (tile, state) item of a stage, at most kMaxWarps
__host__ __device__ __forceinline__ int warps_of(int slab) {
  const int items = 2 * (slab / kTileRows);
  return items < kMaxWarps ? items : kMaxWarps;
}
// A warp's ring slots: kSlots, fewer where the block's rings would pass
// kRingBytes or leave too little of kMaxShared for the chains; and the
// warps' rings with their mbarriers (ops/centered_vg.ring_slots, ring_bytes)
__host__ __device__ __forceinline__ int ring_slots_of(int slab, int b, int chains) {
  const int warps = warps_of(slab);
  const long long left =
      kMaxShared - 8LL * chains * static_cast<long long>(chain_doubles(slab, b));
  const long long most = kRingBytes / (warps * kSlotBytes), room = left / (warps * (kSlotBytes + 8));
  const long long fit = room < most ? room : most;
  return fit < kSlots ? static_cast<int>(fit) : kSlots;
}
__host__ __device__ __forceinline__ size_t ring_bytes_of(int slab, int b, int chains) {
  return static_cast<size_t>(warps_of(slab)) * ring_slots_of(slab, b, chains) * (kSlotBytes + 8);
}
__host__ __device__ __forceinline__ size_t shared_bytes_of(int slab, int b, int chains) {
  // ops/centered_vg.ring_bytes + Cg chain_bytes
  return ring_bytes_of(slab, b, chains) + sizeof(double) * chains * chain_doubles(slab, b);
}

// A warp's stream of prepared tiles through the launch, a slot each: for
// each stage, its items (the block's (tile, state) pairs first, first +
// stride, ...; item = 2 q + d), each item's window in chunks of a slot's k
// steps, each chunk for each of the stage's operators. The cursor walks it
// without a division.
template <typename Tile>
struct Plan {
  const Tile* tiles;
  int n_tiles, ksteps, chunks;  // the grid's row tiles; a window's k steps and slots
  int rt0;                      // the slab's first row tile
  int first, stride, items;     // the warp's items in each stage
};

struct Cursor {
  int s, m, c, op;  // the next chunk to copy: its stage (4: none left), item, chunk, operator
};

template <typename Tile>
__device__ __forceinline__ void advance(const Plan<Tile>& p, Cursor& u) {
  if (++u.op < stage_ops(u.s)) return;
  u.op = 0;
  if (++u.c < p.chunks) return;
  u.c = 0;
  if (++u.m < p.items) return;
  u.m = 0, ++u.s;
}

// A warp's ring of `n` slots (shared::cta addresses `slots` and `bars`,
// `base` the slots as a pointer): the next chunk to consume is in slot
// `head` (its mbarrier's phase `phase`), the next copied goes to slot
// `tail`. Lane 0 issues the copies; every lane waits on the mbarriers.
template <typename Tile>
struct Ring {
  unsigned slots, bars;
  const Tile* base;
  int n, head, phase, tail;
  Cursor copy;
};

// k steps a slot holds
template <typename Tile>
__host__ __device__ constexpr int slot_ksteps() {
  return kSlotBytes / (kFragElems * static_cast<int>(sizeof(Tile)));
}

// Copy the cursor's chunk into slot `tail` (nothing past the plan's end)
template <typename Tile>
__device__ __forceinline__ void copy_next(Ring<Tile>& r, const Plan<Tile>& p, int lane) {
  if (r.copy.s < 4) {
    if (lane == 0) {
      const int item = p.first + r.copy.m * p.stride, d = item & 1, q = item >> 1;
      const int k0 = r.copy.c * slot_ksteps<Tile>();
      const int kc = min(slot_ksteps<Tile>(), p.ksteps - k0);
      const Tile* src =
          p.tiles + ((static_cast<size_t>(stage_op(r.copy.s, r.copy.op) * 2 + d) * p.n_tiles +
                      p.rt0 + q) * p.ksteps + k0) * kFragElems;
      stage_copy(r.slots + r.tail * kSlotBytes, src,
                 static_cast<unsigned>(kc * kFragElems * sizeof(Tile)), r.bars + 8 * r.tail);
    }
    advance(p, r.copy);
  }
  r.tail = r.tail + 1 == r.n ? 0 : r.tail + 1;
}

// The next chunk, once it has landed
template <typename Tile>
__device__ __forceinline__ const Tile* take(Ring<Tile>& r) {
  bar_wait(r.bars + 8 * r.head, static_cast<unsigned>(r.phase));
  const Tile* f = r.base + r.head * (kSlotBytes / static_cast<int>(sizeof(Tile)));
  if (++r.head == r.n) r.head = 0, r.phase ^= 1;
  return f;
}

// acc[op][nt] = A_op X_x over an item's window: the stage's NOPS operators'
// tile (16 rows) times the window's rows of each N tile of 8 chains, k steps
// ascending; xs[x] points at chain 0's staged vector at the window's first
// row, chain c's at c stride doubles further (x = 0 for every op when NX is
// 1). Each chunk waits for its NOPS slots, reads each k step's A fragments
// (the lane's four values) and each N tile's B fragment (chain 8 nt + g,
// rows t and t + 4; zero past the cluster's chains) and multiplies; then
// the warp's lane 0 refills the chunk's slots with the stream's next.
template <int NOPS, int NX, int NT, typename Tile>
__device__ __forceinline__ void item_products(Ring<Tile>& ring, const Plan<Tile>& plan, int lane,
                                              const double* const (&xs)[NX], int stride,
                                              int chains, double (&acc)[NOPS][NT][2][2]) {
  constexpr int kKc = slot_ksteps<Tile>();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int op = 0; op < NOPS; ++op)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      acc[op][nt][0][0] = acc[op][nt][0][1] = acc[op][nt][1][0] = acc[op][nt][1][1] = 0.0;
  for (int k0 = 0; k0 < plan.ksteps; k0 += kKc) {
    const Tile* f[NOPS];
#pragma unroll
    for (int op = 0; op < NOPS; ++op) f[op] = take(ring) + 4 * lane;
#pragma unroll
    for (int k = 0; k < kKc; ++k) {
      if (k0 + k >= plan.ksteps) break;
      double a[NOPS][4];
#pragma unroll
      for (int op = 0; op < NOPS; ++op) load_frag(f[op] + k * kFragElems, a[op]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = nt * kChainTile + g;
        double b0[NX], b1[NX];
#pragma unroll
        for (int x = 0; x < NX; ++x) {
          b0[x] = b1[x] = 0.0;
          if (c < chains) {
            const double* col = xs[x] + static_cast<ptrdiff_t>(c) * stride + kStep * (k0 + k) + t;
            b0[x] = col[0], b1[x] = col[4];
          }
        }
#pragma unroll
        for (int op = 0; op < NOPS; ++op)
          dmma(acc[op][nt], a[op], b0[NX == 1 ? 0 : op], b1[NX == 1 ? 0 : op]);
      }
    }
    __syncwarp();  // every lane has read the chunk's slots
#pragma unroll
    for (int op = 0; op < NOPS; ++op) copy_next(ring, plan, lane);
  }
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

template <typename T, int NT>
__global__ void __launch_bounds__(kMaxThreads, 1) centered_vg_kernel(const VgArgs<T> a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = a.n, b = a.bandwidth, slab = a.slab, chains = a.chains, S = a.cluster;
  const int groups = groups_of(slab), width = width_of(slab, b), stride = stride_of(slab, b);
  const int rank = static_cast<int>(cluster.block_rank());
  const int c0 = (blockIdx.x / S) * chains;  // the cluster's first chain
  const int lo = rank * slab, hi = min(n, lo + slab);
  const int base = lo - b;  // the grid row of a staged vector's position 0
  const int reach = S > 1 ? (b + slab - 1) / slab : 0;  // slabs each side within b rows
  const int tid = threadIdx.x, nthreads = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int warps = nthreads >> 5;
  // the warps' rings and their mbarriers, then per chain: parameters,
  // sums, the gathered sums, partial lanes; then the vectors
  double* params = reinterpret_cast<double*>(smem_raw + ring_bytes_of(slab, b, chains));
  double* totals = params + chains * kParams;
  double* gathered = totals + chains * kSums;  // [rank][chain][sum], rank 0's
  double* parts = gathered + chains * kMaxCluster * (kSums - 1);
  double* vec = parts + static_cast<size_t>(chains) * kLanes * groups;
  auto staged = [&](int v, int d, int c) {
    return vec + (static_cast<size_t>(v * 2 + d) * chains + c) * stride;
  };
  auto lane_at = [&](int c, int l, int e) -> double& {
    return parts[(static_cast<size_t>(c) * kLanes + l) * groups + e];
  };
  // a value of row i (in this block's slab) of vector v, here
  auto put = [&](int v, int c, int d, int i, double value) { staged(v, d, c)[i - base] = value; };
  // The rows of vector v that this block owns and another block's halo
  // holds (within b rows of its slab), every chain and state, into that
  // block's shared memory: consecutive rows on consecutive lanes, after
  // the block's own writes (a __syncthreads) and before the cluster
  // barrier that publishes them
  auto push = [&](int v) {
    for (int q = max(0, rank - reach); q <= min(S - 1, rank + reach); ++q) {
      if (q == rank) continue;
      const int lo_q = q * slab, hi_q = min(n, lo_q + slab);
      const int r0 = max(lo, lo_q - b), r1 = min(hi, hi_q + b), rows = r1 - r0;
      if (rows <= 0) continue;
      double* there = cluster.map_shared_rank(staged(v, 0, 0), q) + (r0 - (lo_q - b));
      const double* here = staged(v, 0, 0) + (r0 - base);
      for (int dc = warp; dc < 2 * chains; dc += warps)
        for (int r = lane; r < rows; r += 32) there[dc * stride + r] = here[dc * stride + r];
    }
  };
  // a staged value of this block's row i
  auto got = [&](int v, int c, int d, int i) { return staged(v, d, c)[i - base]; };

  // The warp's plan and its ring; its first chunks are in flight
  // while the block fills its vectors
  const int tiles_here = (hi - lo + kTileRows - 1) / kTileRows, items_here = 2 * tiles_here;
  Plan<T> plan;
  plan.tiles = a.tiles;
  plan.n_tiles = (n + kTileRows - 1) / kTileRows;
  plan.ksteps = ksteps_of(b);
  plan.chunks = (plan.ksteps + slot_ksteps<T>() - 1) / slot_ksteps<T>();
  plan.rt0 = lo / kTileRows;
  plan.first = warp;
  plan.stride = warps;
  plan.items = warp < items_here ? (items_here - warp + warps - 1) / warps : 0;
  Ring<T> ring;
  ring.n = ring_slots_of(slab, b, chains);
  ring.slots = smem_u32(smem_raw) + warp * ring.n * kSlotBytes;
  ring.bars = smem_u32(smem_raw) + warps * ring.n * kSlotBytes + 8 * ring.n * warp;
  ring.base = reinterpret_cast<const T*>(smem_raw + warp * ring.n * kSlotBytes);
  ring.head = ring.phase = ring.tail = 0;
  ring.copy = Cursor{plan.items > 0 ? 0 : 4, 0, 0, 0};
  if (lane == 0) {
    for (int k = 0; k < ring.n; ++k) bar_init(ring.bars + 8 * k, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncwarp();
  for (int k = 0; k < ring.n; ++k) copy_next(ring, plan, lane);

  const T* s = a.scalars;
  const double beta_deriv = s[0], beta_level = s[1], beta_obs = s[2];
  auto field = [&](int which, int d, int i) -> double {
    return a.fields[(which * 2 + d) * n + min(i, n - 1)];
  };
  auto dx = [&](int c, int d, int i) -> T {
    const int chain = c0 + c;
    return chain < a.n_chains && i >= 0 && i < n
               ? a.dpsi[static_cast<size_t>(chain) * a.dim + d * n + i]
               : T(0);
  };

  // dx over the tile windows, zero outside the grid (each thread's loads
  // in flight together, kFill at a time); E, GS and the partial lanes zero
  // (a tile past the grid keeps no sums); each chain's theta and sigma^2, a
  // thread each (a chain past C: finite stand-ins, never stored)
  {
    // the thread's entries (chain c, state d, position pos) of X, every
    // nthreads-th of the 2 Cg width, kFill loads in flight at a time
    const int step = nthreads / width, step_pos = nthreads - step * width;
    int pos = tid % width, c = tid / width, d = 0;
    while (c >= chains) c -= chains, ++d;
    while (d < 2) {
      double v[kFill];
      int at[kFill];
#pragma unroll
      for (int m = 0; m < kFill; ++m) {
        const bool in = d < 2;
        at[m] = in ? (d * chains + c) * stride + pos : -1;
        v[m] = in ? static_cast<double>(dx(c, d, base + pos)) : 0.0;
        pos += step_pos, c += step;
        if (pos >= width) pos -= width, ++c;
        while (c >= chains) c -= chains, ++d;
      }
#pragma unroll
      for (int m = 0; m < kFill; ++m)
        if (at[m] >= 0) vec[at[m]] = v[m];
    }
  }
  {
    double* eg = staged(kE, 0, 0);  // E and GS, one after the other
    for (int o = tid; o < 2 * 2 * chains * stride; o += nthreads) eg[o] = 0.0;
    for (int o = tid; o < chains * kLanes * groups; o += nthreads) parts[o] = 0.0;
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
  // the chain's quotients and reciprocals its rows share: a row's
  // arithmetic multiplies by a reciprocal where a division was
  for (int c = tid; c < chains; c += nthreads) {
    double* p = params + c * kParams;
    p[5] = dvd(-1.0, p[2]), p[6] = dvd(-p[1], p[2]), p[7] = mul(p[2], p[2]);
    p[8] = dvd(1.0, p[2]), p[9] = dvd(1.0, p[7]);
    p[10] = dvd(1.0, mul(p[3], beta_obs)), p[11] = dvd(1.0, mul(p[4], beta_obs));
  }
  const double inv_deriv = dvd(1.0, beta_deriv), inv_level = dvd(1.0, beta_level);
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
  // block writes into another's: this arrival's wait precedes the first
  // halo push
  __syncthreads();
  arrive();

  // A lane's outputs of an item (tile q, state d): rows i0 + g + 8 h of
  // chains 8 nt + 2 t + e; its sums of a chain go to entry 8 q + g
  const int g = lane >> 2, t = lane & 3;

  // stage 1: u = mphi dx, v = GC^T dx; e, -g / beta_level; sums of r^2
  // (lanes 0, 1 by state) and of g^2 (lanes 2, 3)
  for (int m = 0; m < plan.items; ++m) {
    const int item = warp + m * warps, d = item & 1, q = item >> 1, i0 = lo + q * kTileRows;
    double fl[2][6];  // the rows' fields, loaded while the products run
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + g + 8 * h;
      fl[h][0] = field(kXRef, 0, i), fl[h][1] = field(kXRef, 1, i), fl[h][2] = field(kCE, d, i);
      fl[h][3] = field(kCGC, d, i), fl[h][4] = field(kMask, d, i), fl[h][5] = field(kRRef, d, i);
    }
    double acc[2][NT][2][2];
    const double* const xs[1] = {staged(kXH, d, 0) + q * kTileRows};
    item_products<2, 1, NT>(ring, plan, lane, xs, stride, chains, acc);
    double s_rr[NT][2] = {}, s_gg[NT][2] = {};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + g + 8 * h;
      if (i >= hi) continue;
      const double xr0 = fl[h][0], xr1 = fl[h][1], ce = fl[h][2];
      const double cgc = fl[h][3], mask = fl[h][4], rref = fl[h][5];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = nt * kChainTile + 2 * t + e;
          if (c >= chains) continue;
          const double* p = params + c * kParams;
          const double ta = p[0], tb = p[1], tc = p[2];
          const double x0 = add(xr0, got(kXH, c, 0, i)), x1 = add(xr1, got(kXH, c, 1, i));
          const double f = d == 0 ? mul(tc, add(sub(x0, mul(mul(mul(x0, x0), x0), kThird)), x1))
                                  : mul(p[5], add(sub(x0, ta), mul(tb, x1)));
          put(kE, c, d, i, static_cast<T>(sub(sub(f, ce), acc[0][nt][h][e])));
          const double gg = add(cgc, acc[1][nt][h][e]);
          put(kGS, c, d, i, static_cast<T>(mul(-gg, inv_level)));
          const double rv = mul(mask, add(got(kXH, c, d, i), rref));
          s_rr[nt][e] = add(s_rr[nt][e], mul(rv, rv));
          s_gg[nt][e] = add(s_gg[nt][e], mul(gg, gg));
        }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nt * kChainTile + 2 * t + e;
        if (c >= chains) continue;
        lane_at(c, d, 8 * q + g) = s_rr[nt][e];
        lane_at(c, 2 + d, 8 * q + g) = s_gg[nt][e];
      }
  }
  __syncthreads();
  wait();
  push(kE);
  push(kGS);
  arrive();
  {
    const int first[3] = {0, 1, 2}, count[3] = {1, 1, 2}, slot[3] = {kSse0, kSse1, kG2};
    reduce_parts<3>(parts, totals, chains, groups, first, count, slot);
  }
  __syncthreads();
  wait();  // E and GS complete, halos included

  // stage 2: h = GK^T e; -h / beta_deriv into X; sums of h^2 (lanes 0, 1)
  for (int m = 0; m < plan.items; ++m) {
    const int item = warp + m * warps, d = item & 1, q = item >> 1, i0 = lo + q * kTileRows;
    double acc[1][NT][2][2];
    const double* const xs[1] = {staged(kE, d, 0) + q * kTileRows};
    item_products<1, 1, NT>(ring, plan, lane, xs, stride, chains, acc);
    double s_h[NT][2] = {};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + g + 8 * h;
      if (i >= hi) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = nt * kChainTile + 2 * t + e;
          if (c >= chains) continue;
          const double hv = acc[0][nt][h][e];
          s_h[nt][e] = add(s_h[nt][e], mul(hv, hv));
          put(kXH, c, d, i, static_cast<T>(mul(-hv, inv_deriv)));
        }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nt * kChainTile + 2 * t + e;
        if (c < chains) lane_at(c, d, 8 * q + g) = s_h[nt][e];
      }
  }
  __syncthreads();
  push(kXH);
  arrive();
  {
    const int first[1] = {0}, count[1] = {2}, slot[1] = {kH2};
    reduce_parts<1>(parts, totals, chains, groups, first, count, slot);
  }
  __syncthreads();
  wait();  // H complete

  // stage 3: ebar = GK (-h / beta_deriv), into E
  for (int m = 0; m < plan.items; ++m) {
    const int item = warp + m * warps, d = item & 1, q = item >> 1, i0 = lo + q * kTileRows;
    double acc[1][NT][2][2];
    const double* const xs[1] = {staged(kXH, d, 0) + q * kTileRows};
    item_products<1, 1, NT>(ring, plan, lane, xs, stride, chains, acc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + g + 8 * h;
      if (i >= hi) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = nt * kChainTile + 2 * t + e;
          if (c < chains) put(kE, c, d, i, static_cast<T>(acc[0][nt][h][e]));
        }
    }
  }
  __syncthreads();
  push(kE);
  sync_all();  // ebar complete

  // stage 4: the gradient in dx; the theta gradient's sums (g_c in lanes
  // 0, 1 by state; g_a, g_b of state 1 in lanes 2, 3)
  for (int m = 0; m < plan.items; ++m) {
    const int item = warp + m * warps, d = item & 1, q = item >> 1, i0 = lo + q * kTileRows;
    // the rows' fields and the chains' dx, loaded while the products run
    double fl[2][4];
    T dxs[2][NT][2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + g + 8 * h;
      fl[h][0] = field(kXRef, 0, i), fl[h][1] = field(kXRef, 1, i);
      fl[h][2] = field(kMask, d, i), fl[h][3] = field(kRRef, d, i);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = nt * kChainTile + 2 * t + e;
          dxs[h][nt][e][0] = dx(c, 0, i), dxs[h][nt][e][1] = dx(c, 1, i);
        }
    }
    double acc[2][NT][2][2];
    const double* const xs[2] = {staged(kE, d, 0) + q * kTileRows,
                                 staged(kGS, d, 0) + q * kTileRows};
    item_products<2, 2, NT>(ring, plan, lane, xs, stride, chains, acc);
    double s_a[NT][2] = {}, s_b[NT][2] = {}, s_c[NT][2] = {};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + g + 8 * h;
      if (i >= hi) continue;
      const double xr0 = fl[h][0], xr1 = fl[h][1], mask = fl[h][2], rref = fl[h][3];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = nt * kChainTile + 2 * t + e, chain = c0 + c;
          if (c >= chains) continue;
          const double* p = params + c * kParams;
          const double ta = p[0], tb = p[1], tc = p[2];
          const T dx0 = dxs[h][nt][e][0], dx1 = dxs[h][nt][e][1];
          const double x0 = add(xr0, dx0), x1 = add(xr1, dx1);
          const double e0 = got(kE, c, 0, i), e1 = got(kE, c, 1, i);
          double jx;
          if (d == 0) {
            jx = add(mul(e0, mul(tc, sub(1.0, mul(x0, x0)))), mul(e1, p[5]));
            s_c[nt][e] = add(s_c[nt][e], mul(e0, add(sub(x0, mul(mul(mul(x0, x0), x0), kThird)), x1)));
          } else {
            jx = add(mul(e0, tc), mul(e1, p[6]));
            s_a[nt][e] = add(s_a[nt][e], mul(e1, p[8]));
            s_b[nt][e] = add(s_b[nt][e], mul(e1, mul(-x1, p[8])));
            s_c[nt][e] = add(s_c[nt][e], mul(e1, mul(add(sub(x0, ta), mul(tb, x1)), p[9])));
          }
          const double rv = mul(mask, add(d == 0 ? dx0 : dx1, rref));
          if (chain < a.n_chains)
            a.g_psi[static_cast<size_t>(chain) * a.dim + d * n + i] = static_cast<T>(
                sub(add(sub(jx, acc[0][nt][h][e]), acc[1][nt][h][e]),
                    mul(rv, p[10 + d])));
        }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nt * kChainTile + 2 * t + e;
        if (c >= chains) continue;
        lane_at(c, d, 8 * q + g) = s_c[nt][e];
        if (d == 1) lane_at(c, 2, 8 * q + g) = s_a[nt][e], lane_at(c, 3, 8 * q + g) = s_b[nt][e];
      }
  }
  __syncthreads();
  {
    const int first[3] = {0, 2, 3}, count[3] = {2, 1, 1}, slot[3] = {kGc, kGa, kGb};
    reduce_parts<3>(parts, totals, chains, groups, first, count, slot);
  }
  __syncthreads();
  // every block's sums into rank 0's gathered sums; then only rank 0 goes on
  {
    double* to = S > 1 ? cluster.map_shared_rank(gathered, 0) : gathered;
    for (int o = tid; o < chains * (kSums - 1); o += nthreads) {
      const int c = o / (kSums - 1), j = o % (kSums - 1);
      to[rank * chains * (kSums - 1) + o] = totals[c * kSums + j];
    }
  }
  sync_all();  // rank 0 holds every block's sums
  if (rank != 0) return;

  // each chain's sums, the blocks' partials in rank order (a thread a chain
  // and sum), into the partial lanes
  for (int o = tid; o < chains * (kSums - 1); o += nthreads) {
    double tot = gathered[o];
    for (int q = 1; q < S; ++q) tot = add(tot, gathered[q * chains * (kSums - 1) + o]);
    parts[o] = tot;  // every block's stage sums are read: parts is free
  }
  __syncthreads();

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

// The prepared tiles (ops/centered_vg.prepare_tiles_torch's layout), a
// lane's four values of a k step (its A fragment) a thread
template <typename T>
__global__ void prepare_kernel(const T* __restrict__ bands, T* __restrict__ tiles, int n, int b,
                               int n_tiles, int ksteps, int64_t frags) {
  const int w = 2 * b + 1;
  for (int64_t p = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; p < frags;
       p += int64_t(gridDim.x) * blockDim.x) {
    const int lane = int(p & 31);
    const int64_t rest = p >> 5;  // (operator, state, row tile, k step)
    const int ks = int(rest % ksteps), rt = int((rest / ksteps) % n_tiles);
    const int64_t od = rest / ksteps / n_tiles;
    T v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // r = 2 h + e: row g + 8 e, column t + 4 h
      const int row = kTileRows * rt + (lane >> 2) + 8 * (r & 1);
      const int j = kTileRows * rt - b + kStep * ks + (lane & 3) + 4 * (r >> 1), k = j - row;
      v[r] = row < n && j >= 0 && j < n && k >= -b && k <= b ? bands[(od * w + b + k) * n + j]
                                                             : T(0);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) tiles[4 * p + r] = v[r];
  }
}

template <typename T>
int prepare(const void* bands, void* tiles, int n, int b, void* stream) {
  if (n < 1 || b < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (n + kTileRows - 1) / kTileRows, ks = ksteps_of(b);
  const int64_t frags = int64_t(6 * 2) * n_tiles * ks * (kFragElems / 4);
  const int threads = 256;
  const int64_t blocks = (frags + threads - 1) / threads;
  prepare_kernel<T><<<unsigned(blocks < 65535 ? blocks : 65535), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(bands), static_cast<T*>(tiles), n, b, n_tiles, ks, frags);
  return static_cast<int>(cudaGetLastError());
}

// The launch's integer arguments, in the order of ops/centered_vg.INTS
struct Launch {
  int n_chains, n, bandwidth, dim, sigma_sampled, theta_kind, cluster, slab, chains, threads;
  long long shared;
};

template <typename T>
void (*kernel_for(int ntiles))(const VgArgs<T>) {
  return ntiles == 4   ? centered_vg_kernel<T, 4>
         : ntiles == 3 ? centered_vg_kernel<T, 3>
         : ntiles == 2 ? centered_vg_kernel<T, 2>
                       : centered_vg_kernel<T, 1>;
}

int ntiles_of(int chains) { return chains < kChainTile ? 1 : chains / kChainTile; }

// The launch's checks: the tiling is one that ops/centered_vg.tiling gives
bool valid(const Launch& l) {
  const int warps = l.threads / 32;
  return l.n >= 1 && l.bandwidth >= 0 && l.cluster >= 1 && l.cluster <= kMaxCluster &&
         l.slab >= kTileRows && l.slab % kTileRows == 0 &&
         static_cast<long long>(l.slab) * l.cluster >= l.n &&
         static_cast<long long>(l.slab) * (l.cluster - 1) < l.n && l.chains >= 1 &&
         (l.chains < kChainTile ||
          (l.chains % kChainTile == 0 && l.chains / kChainTile <= kMaxNTiles)) &&
         l.threads % 32 == 0 && warps == warps_of(l.slab) &&
         ring_slots_of(l.slab, l.bandwidth, l.chains) >= 2 &&
         l.shared == static_cast<long long>(shared_bytes_of(l.slab, l.bandwidth, l.chains));
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
  l.threads = static_cast<int>(ints[9]);
  l.shared = ints[10];
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
  if (ints[11] != kNPointers || ints[12] != kNInts) return static_cast<int>(cudaErrorInvalidValue);
  const Launch l = parse(ints);
  if (l.n_chains <= 0) return 0;
  if (!valid(l)) return static_cast<int>(cudaErrorInvalidValue);
  VgArgs<T> a;
  a.dpsi = static_cast<const T*>(ptrs[0]);
  a.tiles = static_cast<const T*>(ptrs[1]);
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
  cudaLaunchAttribute attr[1];
  const int clusters = (l.n_chains + l.chains - 1) / l.chains;
  const cudaLaunchConfig_t config =
      config_for(l, clusters, static_cast<cudaStream_t>(stream), attr);
  return static_cast<int>(cudaLaunchKernelEx(&config, kernel_for<T>(ntiles_of(l.chains)), a));
}

template <typename T>
cudaError_t init_instances() {
  int dev = 0, bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  for (int nt = 1; nt <= kMaxNTiles; ++nt) {
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel_for<T>(nt), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
  }
  return err;
}

}  // namespace

extern "C" {

// Every instance may use the device's whole opt-in shared memory a block
// (clusters of up to kMaxCluster blocks are within the portable size, 8).
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
  const void* fn = f64 ? reinterpret_cast<const void*>(kernel_for<double>(ntiles_of(l.chains)))
                       : reinterpret_cast<const void*>(kernel_for<float>(ntiles_of(l.chains)));
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, fn, &config));
}

int centered_vg_f32(const void* const* ptrs, const long long* ints, void* stream) {
  return launch<float>(ptrs, ints, stream);
}

int centered_vg_f64(const void* const* ptrs, const long long* ints, void* stream) {
  return launch<double>(ptrs, ints, stream);
}

// The prepared tiles of contiguous storages (6, 2, 2b+1, n) into tiles of
// ops/centered_vg.tiles_shape(n, b) values of the storages' type.
int centered_vg_prepare_f32(const void* bands, void* tiles, int n, int b, void* stream) {
  return prepare<float>(bands, tiles, n, b, stream);
}

int centered_vg_prepare_f64(const void* bands, void* tiles, int n, int b, void* stream) {
  return prepare<double>(bands, tiles, n, b, stream);
}

}  // extern "C"
