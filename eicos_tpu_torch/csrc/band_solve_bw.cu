// band_fwd_bw / band_bwd_bw: the two triangular sweeps of a block-banded
// LDL^T solve at block bandwidth bw = 1..6, for a batch of lanes and up to 16
// right-hand sides.
//
// Replace the Pallas kernels _make_fwd_bw / _make_bwd_bw (through
// band_solve_ds_bw) of eicos_tpu/ops/pallas_band_ds.py.  Those stream a
// double-single factor and carry bw y or z blocks (and, backward, bw^2 L
// blocks) in VMEM rings; these read the f64 factor of band_factor_bw.cu, with
// L[k, k-j] stored at L[k][j-1]:
//
//   band_fwd_bw: y_k = Dinv_k (x_k - sum_{j=1..bw} L[k,k-j] y_{k-j}),
//                w_k = y_k / d_k
//   band_bwd_bw: z_k = Dinv_k^T (w_k - sum_{j=1..bw} L[k+j,k]^T z_{k+j}),
//                k = nb-1 .. 0
//
// Right-hand sides keep the layout of eicos_tpu's band_solve_ds_bw, (k, Dp)
// per lane: row `col` of lane `l` is rhs[(l * k + col) * Dp + row].
//
// Bound: each sweep needs the factor once, per lane and block row bw blocks
// of L (128 KB each) and the lower triangle of the unit-lower Dinv (64.5 KB),
// for 2 x 128^2 x k operations per full block: at most 4 operations per byte
// at k = 16, so the sweeps are bound by HBM bytes.  What keeps a sweep from
// that bound is latency: only the 128 x k y (or z) blocks carry the
// dependency from one block row to the next, and each block row stops its
// consumers twice, at the exchanges of the residual and of the new y block.
//
// Design:
// - Each lane runs on a thread-block cluster of C = 2 CTAs (64 lanes fill
//   128 of the 132 SMs).  Forward CTA `rank` owns rows [rank R, rank R + R),
//   R = 64, of every L[b, b-j] product, backward those columns of every
//   L[b+j, b]^T product (the transposed products).
// - The factor stream runs ahead of the arithmetic.  Every panel a lane
//   reads is known before the sweep starts, so one thread of a producer warp
//   walks them in the consumers' order, across block and block-row
//   boundaries, into a ring of `stages` slots in shared memory: a tensor-map
//   copy (cp.async.bulk.tensor) a panel, each slot's "full" mbarrier counting
//   its bytes.  An L panel is PW = 32 terms of the CTA's 64 rows (forward: a
//   box 2 elements wider than the 32, so that its rows land RLD apart for
//   conflict-free reads, the 2 read as zeros from past the map's edge) or
//   of its 64 columns (backward).  The eight consumer warps wait on "full",
//   multiply, and arrive on the slot's "empty" mbarrier; the producer waits
//   only for an empty slot, never on an exchange, so the ring refills while
//   the consumers join and exchange.  `stages` comes from the wrapper
//   (ops/band.py `sweep_stages`: the deepest ring that fits the card's
//   shared memory a block beside yring, acc and red, and keeps as many
//   clusters resident as a ring of 4); 4 at bw 6 and k 16.
// - Only the lower triangle of Dinv is read, in tiles of 32 x 32: a tile
//   above the diagonal (exact zeros, band_factor_bw.cu) is multiplied as
//   zeros without a read.  The Dinv product's rows (columns) go to the CTAs
//   in groups of 32, 0..31 and 96..127 to CTA 0, 32..95 to CTA 1, so that
//   each reads 5 tiles (`dinv_state`).
// - The residual block (x_b - sum L y) and the new y (or z) block are
//   exchanged through distributed shared memory: each consumer thread
//   stores its entries into every CTA of the cluster with st.async, whose
//   bytes complete on that CTA's exchange mbarrier; thread 0 arrives once a
//   phase, for the next one as soon as it has seen one complete.  No fence
//   and no cluster barrier: a writer never waits for its stores.  A phase
//   completes only once every consumer thread of both CTAs has passed the
//   join that precedes its stores, so the exchange after the y block also
//   guarantees that every CTA has read y_{b-bw} and acc before they are
//   overwritten.  Each block row's right-hand side (and pivots) is read
//   ahead of the products, and its outputs are written after the stores.
// - A consumer thread owns one row (column) and every NG-th term of each
//   panel's contraction, a warp 16 rows and two neighbouring groups of
//   terms (32 distinct bank pairs of a forward panel); the NG partial sums
//   of a row are joined in a fixed order, so a repeated call gives the same
//   bits, whatever the ring's depth or the CTA that holds a row.  The
//   right-hand sides are carried KT wide (2, 8 or 16: the k of the call
//   rounded up), zero past k.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cgr = cooperative_groups;

namespace {

constexpr int B = 128;
constexpr int KP = 16;   // most right-hand sides per call
constexpr int NC = 256;             // consumer threads a CTA
constexpr int NCW = NC / 32;        // consumer warps
constexpr int NT = NC + 32;         // and the producer warp
constexpr int PANEL = 2048;   // doubles of the factor a panel carries
constexpr int BW_MAX = 6;
constexpr int C = 2;                // CTAs a lane (a cluster)
constexpr int R = B / C;            // rows a CTA owns
constexpr int PW = PANEL / R;       // contraction terms a panel
constexpr int PPB = B / PW;         // panels a full block
constexpr int NG = NC / R;          // threads a row
constexpr int RLD = PW + 2;         // forward panel row stride
constexpr int PSZ = R * RLD;        // doubles a ring stage
constexpr int H = PW;               // rows (columns) of a Dinv half panel
constexpr int HSZ = H * RLD;        // doubles a stage's half

// What group g (0 or 1: its local rows, or backward columns, 0..31 or
// 32..63) of CTA `rank`'s share of Dinv_b does with the panel of the terms
// [p PW, p PW + PW).  A row sums a fixed set of terms, in order: forward
// rows 0..63 the terms 0..63 and rows 64..127 all 128, backward columns
// 0..63 all 128 and columns 64..127 the terms 64..127; a tile of them above
// the diagonal is multiplied as zeros, without a read.  CTA 0 holds the
// groups of rows (columns) 0..31 and 96..127, CTA 1 those of 32..95.
enum { SKIP, ZERO, LOAD };
__host__ __device__ constexpr int dinv_group(int rank, int g) {
  return rank == 0 ? 3 * g : 1 + g;   // its tile of rows (columns)
}
__host__ __device__ constexpr int dinv_state(bool fwd, int rank, int g,
                                             int p) {
  return fwd ? (p >= (dinv_group(rank, g) < 2 ? 2 : 4) ? SKIP
                : p > dinv_group(rank, g)              ? ZERO
                                                       : LOAD)
             : (p < (dinv_group(rank, g) < 2 ? 0 : 2) ? SKIP
                : p < dinv_group(rank, g)            ? ZERO
                                                     : LOAD);
}

// shared memory of a CTA: the ring, yring, acc, red, then the mbarriers
// (full and empty a stage, two exchanges); ops/band.py `sweep_smem` is the
// same sum
size_t smem_bytes(int stages, int bw, int kt) {
  return (size_t)(stages * PSZ + (bw + 1) * B * kt + NG * R * kt) *
             sizeof(double) +
         (size_t)(2 * stages + 2) * sizeof(uint64_t);
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ bool bar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait for the phase of `parity` of a barrier this CTA's threads arrive on
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = saddr(bar);
  while (!bar_test(a, parity)) {
  }
}

// the same for a barrier whose bytes the cluster's CTAs store (`store_at`):
// acquire at cluster scope, so that their stores into this CTA are seen
__device__ __forceinline__ void bar_wait_cluster(uint64_t* bar,
                                                 uint32_t parity) {
  const uint32_t a = saddr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(bar))
               : "memory");
}

// store v at `p` in CTA `rank` of the cluster, its bytes completed on that
// CTA's `bar`: an asynchronous store that needs no fence
__device__ __forceinline__ void store_at(double* p, int rank, double v,
                                         uint64_t* bar) {
  asm volatile(
      "{\n.reg .b32 ra, rb;\n"
      "mapa.shared::cluster.u32 ra, %0, %2;\n"
      "mapa.shared::cluster.u32 rb, %1, %2;\n"
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f64 [ra], %3, "
      "[rb];\n}\n" ::"r"(saddr(p)),
      "r"(saddr(bar)), "r"(rank), "d"(v)
      : "memory");
}

// arrive on `bar`, its phase to complete once `bytes` more have come
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          saddr(bar)),
      "r"(bytes)
      : "memory");
}

// copy the box of `map` at coordinates c (innermost first; N of them) into
// shared memory at `dst` (128-byte aligned), counted on `bar`'s transaction
// bytes
template <int N>
__device__ __forceinline__ void tile_load(double* dst, const CUtensorMap* map,
                                          const int (&c)[N], uint64_t* bar) {
  static_assert(N == 2 || N == 3, "2- or 3-d boxes");
  if constexpr (N == 2)
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(saddr(dst)),
        "l"(map), "r"(c[0]), "r"(c[1]), "r"(saddr(bar))
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
            saddr(dst)),
        "l"(map), "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(saddr(bar))
        : "memory");
}

// the consumers' own barrier (the producer warp is not in it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory");
}

// FWD: row slabs (rows r0.., PW terms, stored [row][term]); else column
// slabs (PW terms, columns r0.., stored [term][column]).  mL and mD map L
// and Dinv (`maps`).
template <int KT, bool FWD>
__global__ void __launch_bounds__(NT, 1)
sweep_kernel(const __grid_constant__ CUtensorMap mL,
             const __grid_constant__ CUtensorMap mD,
             const double* __restrict__ d, const double* __restrict__ rhs,
             double* __restrict__ out, int nb, int bw, int k, int stages) {
  extern __shared__ __align__(128) double smem[];
  double* ring = smem;                          // stages x PSZ
  double* yring = ring + stages * PSZ;          // bw x (B x KT)
  double* acc = yring + bw * B * KT;            // B x KT
  double* red = acc + B * KT;                   // NG x R x KT
  uint64_t* full = (uint64_t*)(red + NG * R * KT);   // a stage
  uint64_t* empty = full + stages;                   // a stage
  uint64_t* xch = empty + stages;   // [0]: the residual, [1]: the y block

  cgr::cluster_group cl = cgr::this_cluster();
  const int rank = (int)cl.block_rank();
  const int r0 = rank * R;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane_id = tid % 32;
  const int Dp = nb * B;
  const size_t lane = blockIdx.x / C;
  const double* x_l = rhs + lane * k * Dp;
  double* o_l = out + lane * k * Dp;

  // panels of block row b: its L blocks, then those of Dinv_b that a group
  // reads (`dinv_state`)
  auto jmax = [&](int b) {
    const int m = FWD ? b : nb - 1 - b;
    return m < bw ? m : bw;
  };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, NCW);
    }
    // an exchange's phase: this thread's arrival and a block of bytes
    for (int x = 0; x < 2; ++x) {
      bar_init(xch + x, 1);
      bar_expect(xch + x, B * KT * sizeof(double));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every CTA of the cluster runs, its barriers set, before any copy into
  // it or arrival on them
  cl.sync();

  if (warp == NCW) {
    // ---- the producer: the panel stream, in the consumers' order, from
    // one thread: a box a panel (a Dinv panel, one a group that reads it)
    if (lane_id != 0) return;
    int slot = 0, round = 0;
    // the next slot, once empty, to be filled by `bytes`
    auto claim = [&](uint32_t bytes) {
      if (round > 0) bar_wait(empty + slot, (round - 1) & 1);
      bar_expect(full + slot, bytes);
      const int at = slot;
      if (++slot == stages) {
        slot = 0;
        ++round;
      }
      return at;
    };
    const uint32_t half = (FWD ? HSZ : H * H) * sizeof(double);
    for (int step = 0; step < nb; ++step) {
      const int b = FWD ? step : nb - 1 - step;
      for (int j = 1; j <= jmax(b); ++j) {
        const int bL = (int)((lane * nb + (FWD ? b : b + j)) * bw + j - 1);
        for (int p = 0; p < PPB; ++p) {
          const int at = claim((FWD ? PSZ : PANEL) * sizeof(double));
          if (FWD)
            tile_load<3>(ring + at * PSZ, &mL, {0, p, bL * B + r0},
                         full + at);
          else
            tile_load<2>(ring + at * PSZ, &mL, {r0, bL * B + p * PW},
                         full + at);
        }
      }
      const int bD = (int)((lane * nb + b) * B);   // Dinv_b's first row
      for (int p = 0; p < PPB; ++p) {
        const int n = (dinv_state(FWD, rank, 0, p) == LOAD) +
                      (dinv_state(FWD, rank, 1, p) == LOAD);
        if (!n) continue;
        const int at = claim(n * half);
        for (int g = 0; g < 2; ++g) {
          if (dinv_state(FWD, rank, g, p) != LOAD) continue;
          const int g0 = dinv_group(rank, g) * H;
          double* dst = ring + at * PSZ + g * HSZ;
          if (FWD)
            tile_load<3>(dst, &mD, {0, p, bD + g0}, full + at);
          else
            tile_load<2>(dst, &mD, {g0, bD + p * PW}, full + at);
        }
      }
    }
    return;
  }

  // ---- the consumers
  // a warp holds 16 rows and two neighbouring groups of terms, so that
  // its lanes read 32 distinct bank pairs of a forward panel
  const int i = 16 * (warp % 4) + lane_id % 16;
  const int grp = 2 * (warp / 4) + lane_id / 16;
  int slot = 0, round = 0;
  // the next slot of the stream, once full
  auto take = [&]() {
    bar_wait(full + slot, round & 1);
    return ring + slot * PSZ;
  };
  // the slot taken last is read by this warp
  auto release = [&]() {
    __syncwarp();
    if (lane_id == 0) bar_arrive(empty + slot);
    if (++slot == stages) {
      slot = 0;
      ++round;
    }
  };
  // s += a x (vec rows p PW + t) over this thread's terms t of a panel,
  // a(t) its element of the panel
  auto terms = [&](double (&s)[KT], const double* vec, int p, auto a) {
#pragma unroll
    for (int u = 0; u < PW / NG; ++u) {
      const int t = grp + u * NG;
      const double at = a(t);
      const double* v = vec + (p * PW + t) * KT;
#pragma unroll
      for (int col = 0; col < KT; ++col) s[col] = fma(at, v[col], s[col]);
    }
  };
  // an L block, rows (columns) r0..: s += L x vec, a panel of the terms
  // [p PW, p PW + PW) at a time
  auto l_block = [&](double (&s)[KT], const double* vec) {
    for (int p = 0; p < PPB; ++p) {
      const double* P = take();
      terms(s, vec, p,
            [&](int t) { return FWD ? P[i * RLD + t] : P[t * R + i]; });
      release();
    }
  };
  // Dinv_b's panels: s += this thread's row (column) of them x acc
  const int dg = i / H, di = i % H;   // its group, and row (column) in it
  auto dinv_panels = [&](double (&s)[KT]) {
#pragma unroll
    for (int p = 0; p < PPB; ++p) {
      const bool used = dinv_state(FWD, rank, 0, p) == LOAD ||
                        dinv_state(FWD, rank, 1, p) == LOAD;
      const int state = dinv_state(FWD, rank, dg, p);
      const double* P = used ? take() + dg * HSZ : nullptr;
      if (state == LOAD)
        terms(s, acc, p,
              [&](int t) { return FWD ? P[di * RLD + t] : P[t * H + di]; });
      else if (state == ZERO)
        terms(s, acc, p, [](int) { return 0.0; });
      if (used) release();
    }
  };
  // the row of Dinv_b that local row r of this CTA's share stands for
  auto dinv_row = [&](int r) { return dinv_group(rank, r / H) * H + r % H; };

  // entries (row e / KT, col e % KT) of a block that this thread joins:
  // e = tid + q NC, q < NE, where e < R KT
  constexpr int NE = (R * KT + NC - 1) / NC;
  // sum[q] <- the NG partial sums of entry q, joined in a fixed order
  auto join = [&](const double (&s)[KT], double (&sum)[NE]) {
#pragma unroll
    for (int col = 0; col < KT; ++col) red[(grp * R + i) * KT + col] = s[col];
    consumers_sync();
#pragma unroll
    for (int q = 0; q < NE; ++q) {
      const int e = tid + q * NC;
      if (e >= R * KT) break;
      const int r = e / KT, col = e % KT;
      sum[q] = red[r * KT + col];
      for (int g = 1; g < NG; ++g) sum[q] += red[(g * R + r) * KT + col];
    }
  };
  // write entry q's v at column e % KT of `buf` in every CTA of the
  // cluster, counted on its exchange `x`: at row r0 + e / KT of the
  // residual (x 0), or the row of Dinv_b's share that e / KT stands for
  auto share = [&](double* buf, const double (&v)[NE], int x) {
#pragma unroll
    for (int q = 0; q < NE; ++q) {
      const int e = tid + q * NC;
      if (e >= R * KT) break;
      const int row = x == 0 ? r0 + e / KT : dinv_row(e / KT);
#pragma unroll
      for (int c = 0; c < C; ++c)
        store_at(buf + row * KT + e % KT, c, v[q], xch + x);
    }
  };
  // wait for exchange x's block; then thread 0 arrives for its next phase
  auto gather = [&](int x, uint32_t phase) {
    bar_wait_cluster(xch + x, phase);
    if (tid == 0) bar_expect(xch + x, B * KT * sizeof(double));
  };

  for (int step = 0; step < nb; ++step) {
    const int b = FWD ? step : nb - 1 - step;
    const int jm = jmax(b);
    const uint32_t phase = step & 1;
    // the block row's right-hand side (and pivots), read ahead of the
    // products that need them
    double xv[NE], dv[NE], sum[NE];
#pragma unroll
    for (int q = 0; q < NE; ++q) {
      const int e = tid + q * NC;
      const int row = b * B + r0 + e / KT, col = e % KT;
      xv[q] = e < R * KT && col < k ? x_l[(size_t)col * Dp + row] : 0.0;
      dv[q] = FWD && e < R * KT ? d[lane * Dp + b * B + dinv_row(e / KT)]
                                : 1.0;
      sum[q] = 0.0;
    }
    double s[KT];
#pragma unroll
    for (int col = 0; col < KT; ++col) s[col] = 0.0;
    for (int j = 1; j <= jm; ++j)
      l_block(s, yring + ((FWD ? b - j : b + j) % bw) * B * KT);
    join(s, sum);
#pragma unroll
    for (int q = 0; q < NE; ++q) xv[q] -= sum[q];
    share(acc, xv, 0);
    gather(0, phase);   // the residual block is whole here

#pragma unroll
    for (int col = 0; col < KT; ++col) s[col] = 0.0;
    dinv_panels(s);
    join(s, sum);
    share(yring + (b % bw) * B * KT, sum, 1);
#pragma unroll
    for (int q = 0; q < NE; ++q) {
      const int e = tid + q * NC;
      if (e >= R * KT) break;
      const int row = b * B + dinv_row(e / KT), col = e % KT;
      if (col < k) o_l[(size_t)col * Dp + row] = FWD ? sum[q] / dv[q] : sum[q];
    }
    // y_b is whole here; every CTA has read y_{b-bw} and acc
    gather(1, phase);
  }
}

// *map <- a tiled map of the f64 array at `base` (16-byte aligned) of
// `rank` dimensions `dims` (innermost first; byte strides of the outer
// ones `strides`), boxes `box`; elements outside read as zeros
int encode(CUtensorMap* map, const double* base, int rank,
           const cuuint64_t* dims, const cuuint64_t* strides,
           const cuuint32_t* box) {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
    if (err != cudaSuccess) return (int)err;
    if (q != cudaDriverEntryPointSuccess || !p)
      return (int)cudaErrorNotSupported;
    fn = (PFN_cuTensorMapEncodeTiled_v12000)p;
  }
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT64, rank,
                        (void*)base, dims, strides, box, one,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// the maps of a sweep over `nl` L blocks and `nd` Dinv blocks.  Forward, a
// box is 64 rows (an L panel) or 32 (a Dinv half panel) of one PW-term
// quarter of a block row, 2 elements wider than the quarter so that its
// rows land RLD apart (the 2 read as zeros): maps over (rows, 4 quarters,
// PW terms).  Backward, a box is PW rows of 64 columns (L) or 32 (Dinv):
// maps over (rows, 128 columns).
template <bool FWD>
int maps(CUtensorMap* mL, CUtensorMap* mD, const double* L,
         const double* Dinv, size_t nl, size_t nd) {
  const cuuint64_t row = B * sizeof(double);
  int e;
  if (FWD) {
    const cuuint64_t quarters[2] = {PW * sizeof(double), row};
    const cuuint64_t dL[3] = {PW, PPB, nl * B}, dD[3] = {PW, PPB, nd * B};
    const cuuint32_t bL[3] = {RLD, 1, R}, bD[3] = {RLD, 1, H};
    if ((e = encode(mL, L, 3, dL, quarters, bL))) return e;
    return encode(mD, Dinv, 3, dD, quarters, bD);
  }
  const cuuint64_t dL[2] = {B, nl * B}, dD[2] = {B, nd * B};
  const cuuint32_t bL[2] = {R, PW}, bD[2] = {H, PW};
  if ((e = encode(mL, L, 2, dL, &row, bL))) return e;
  return encode(mD, Dinv, 2, dD, &row, bD);
}

template <int KT, bool FWD>
int launch(const double* L, const double* Dinv, const double* d,
           const double* rhs, double* out, int lanes, int nb, int bw, int k,
           int stages, cudaStream_t stream) {
  CUtensorMap mL, mD;
  const int e = maps<FWD>(&mL, &mD, L, Dinv, (size_t)lanes * nb * bw,
                          (size_t)lanes * nb);
  if (e) return e;
  auto kern = sweep_kernel<KT, FWD>;
  const size_t smem = smem_bytes(stages, bw, KT);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(lanes * C);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, mL, mD, d, rhs, out, nb, bw, k,
                           stages);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// clusters of the kernel at (k, bw, stages) that the current device holds
// at once
template <int KT, bool FWD>
int clusters(int bw, int stages, int* n) {
  auto kern = sweep_kernel<KT, FWD>;
  const size_t smem = smem_bytes(stages, bw, KT);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(n, kern, &cfg);
}

bool valid(int lanes, int nb, int bw, int k, int stages) {
  return bw >= 1 && bw <= BW_MAX && k >= 1 && k <= KP && lanes >= 1 &&
         nb >= 1 && stages >= 1;
}

template <bool FWD>
int dispatch(const double* L, const double* Dinv, const double* d,
             const double* rhs, double* out, int lanes, int nb, int bw, int k,
             int stages, void* stream) {
  if (!valid(lanes, nb, bw, k, stages)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 2)
    return launch<2, FWD>(L, Dinv, d, rhs, out, lanes, nb, bw, k, stages, s);
  if (k <= 8)
    return launch<8, FWD>(L, Dinv, d, rhs, out, lanes, nb, bw, k, stages, s);
  return launch<16, FWD>(L, Dinv, d, rhs, out, lanes, nb, bw, k, stages, s);
}

}  // namespace

// L: (lanes, nb, bw, 128, 128) f64 with L[k][j-1] = L[k, k-j]; Dinv: (lanes,
// nb, 128, 128) f64, unit lower with exact zeros above the diagonal; d:
// (lanes, nb, 128) f64; rhs, out: (lanes, k, nb * 128) f64 with 1 <= k <= 16
// and 1 <= bw <= 6, every pointer 16-byte aligned; `stages` >= 1 slots of the
// panel ring (ops/band.py `sweep_stages`).  Returns the CUDA error code of
// the launch (0 on success, cudaErrorInvalidValue for an argument out of
// range; a ring too deep for the card's shared memory fails the launch).
extern "C" int eicos_band_fwd_bw(const double* L, const double* Dinv,
                                 const double* d, const double* rhs,
                                 double* out, int lanes, int nb, int bw, int k,
                                 int stages, void* stream) {
  return dispatch<true>(L, Dinv, d, rhs, out, lanes, nb, bw, k, stages,
                        stream);
}

// L, Dinv as for eicos_band_fwd_bw; w, out: (lanes, k, nb * 128) f64.
extern "C" int eicos_band_bwd_bw(const double* L, const double* Dinv,
                                 const double* w, double* out, int lanes,
                                 int nb, int bw, int k, int stages,
                                 void* stream) {
  return dispatch<false>(L, Dinv, nullptr, w, out, lanes, nb, bw, k, stages,
                         stream);
}

// *out <- the shared memory a block may opt in to on the current device.
extern "C" int eicos_band_sweep_smem(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(
      out, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// *out <- how many clusters (of 2 CTAs, one lane each) of the forward
// (fwd != 0) or backward sweep at (k, bw, stages) the current device holds
// at once.
extern "C" int eicos_band_sweep_clusters(int fwd, int k, int bw, int stages,
                                         int* out) {
  if (!valid(1, 1, bw, k, stages)) return (int)cudaErrorInvalidValue;
  if (fwd) {
    if (k <= 2) return clusters<2, true>(bw, stages, out);
    if (k <= 8) return clusters<8, true>(bw, stages, out);
    return clusters<16, true>(bw, stages, out);
  }
  if (k <= 2) return clusters<2, false>(bw, stages, out);
  if (k <= 8) return clusters<8, false>(bw, stages, out);
  return clusters<16, false>(bw, stages, out);
}
