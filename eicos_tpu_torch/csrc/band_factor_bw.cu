// band_factor_bw: block-banded LDL^T at block bandwidth bw = 1..6 of a batch
// of lanes, f64.
//
// Replaces the Pallas kernels _make_band_factor_bw (through band_factor_ds_bw)
// of eicos_tpu/ops/pallas_band_ds.py and, at bw = 1, the block-tridiagonal
// ones: _band_factor_kernel (_band_factor_ds_impl), _make_band_factor_tiled
// (_band_factor_ds_batch) and _make_band_factor_tiled_pre
// (_band_factor_pre_batch, the main path's).  Those work on double-single
// pairs, balance every product by sqrt|d| (to keep bf16 chunks in range)
// and carry the last bw rows' Dinv, d and L blocks in VMEM rings.  This
// kernel computes the same object in native IEEE f64, without the balancing
// and without the rings.
//
// Per lane, for block rows k = 0..nb-1 (B = 128), with L[k, k-j] stored at
// L[k][j-1] and every term that reaches above block row 0 left out:
//   for j = bw..1:
//     S        = Ksubs[k][j-1] - sum_{q=j+1..bw} (L[k,k-q] d_{k-q}) L[k-j,k-q]^T
//     L[k,k-j] = S Dinv_{k-j}^T / d_{k-j}
//   M      = Kd_k - sum_{q=1..bw} (L[k,k-q] d_{k-q}) L[k,k-q]^T
//   M      = Lkk diag(d_k) Lkk^T, unpivoted, |d| clamped to >= 1e-150
//   Dinv_k = Lkk^{-1}
// Ksubs[k][j-1] with k < j is never read, and L[k][j-1] is zero there.
//
// Bound: per block row the function needs bw (bw - 1) / 2 general products of
// 2 x 128^3 operations (the corrections of S), bw products with a unit-lower
// Dinv and bw symmetric Schur updates of which the leaf reads the lower
// triangle (128^3 each), and the leaf: (bw (bw + 1) + 5/6) x 128^3, 12.8 x
// 128^3 at bw = 3.  Against (2 bw + 2) x 128 KB of HBM traffic (read Kd,
// Ksubs; write L, Dinv) that is 11 (bw = 1) to 49 (bw = 6) operations per
// byte, above the H100's f64 balance point of 20 from bw = 3 on: bytes bound
// it at bw 1 and 2, operations from 3.
//
// Design: one CTA per lane walks the block rows in order (a lane's rows are
// a strict sequence; splitting a lane over a cluster is later work).
// - Products on DMMA (mma.sync m16n8k8 f64, mma_f64.cuh).  The 128x128
//   output is cut into 16x8 tiles: for a general product warp w takes row
//   block w (16 tiles, 64 accumulators a thread); for the Schur update only
//   the 72 tiles on or below the diagonal exist, nine a warp (row blocks p
//   and 7 - p shared by two warps).  The product with the unit-lower Dinv
//   clips its contraction to the triangle (stage kc skips the column tiles
//   left of it).  So a row needs the function's (bw (bw + 1) + 1/2) x 128^3
//   of products (12.5 x 128^3 at bw = 3, where the FMA design computed 18).
// - The operands stream through a 2-stage cp.async ring of 128 x 16 slabs
//   (16-byte copies through L2 only: L, Dinv and d of earlier rows are this
//   CTA's own output, ordered by a block barrier after their stores; odd
//   rows' pairs swizzled for conflict-free fragment loads); one block
//   barrier a stage, one stage in flight while the tensor cores work on the
//   other.  The scale -d of a product's left operand is
//   applied to its fragments in registers.  S, the one resident 128x128
//   buffer (row stride 136: conflict-free fragment loads), holds the
//   corrected sub-diagonal block as the Dinv product's left operand, and
//   then M for the leaf (leaf.cuh: the blocked leaf of leaf_ldl.cu, with the
//   ring as its panel scratch).  206 KB of shared memory.
// - Every output element is summed by one thread in one fixed order, no
//   atomics: a repeated call gives the same bits.  The bandwidth is a
//   template parameter; the loops over j and q stay rolled, so each form
//   of the product is inlined once (faster at bw = 3 than unrolled).  The
//   general product's 64 accumulators a thread fill the 255 registers:
//   ptxas spills 56-80 bytes at bw 2-6, none at bw 1.

#include <cuda_runtime.h>

#include "leaf.cuh"
#include "mma_f64.cuh"

namespace {

constexpr int B = leaf::B;
constexpr int LD = leaf::ld<double>();   // row stride of S
constexpr int NT = leaf::NT;
constexpr int BK = 16;                   // contraction depth of a stage
constexpr int NK = B / BK;               // stages a product
constexpr int STAGES = 2;
constexpr int OPND = B * BK;             // one operand's slab: rows of BK
constexpr int STAGE = 2 * OPND;
constexpr int RING = STAGES * STAGE;
static_assert(RING >= B * leaf::WLD, "the leaf's panel scratch is the ring");
constexpr int BW_MAX = 6;

// element (x, k) of a slab, k even: rows of BK = 16, the pairs of odd rows
// swapped by halves (k ^ 8), so that the 16-byte fragment loads of a
// quarter warp (rows g, g + 1, pairs t or 4 + t) fall on distinct bank
// groups
static_assert(BK == 16, "slot() swizzles rows of 16");
__device__ __forceinline__ int slot(int x, int k) {
  return x * BK + (k ^ ((x & 1) << 3));
}

enum Form { GENERAL, LOWER };

template <int FORM>
constexpr int NTILES = FORM == GENERAL ? 16 : 9;   // tiles a warp

// tile i of warp w: row block ra (16 rows) and column tile cb (8 columns).
// LOWER: row block a holds the 2a + 2 tiles on or below the diagonal; the
// 18 tiles of row blocks p and 7 - p are split nine and nine between warps
// p and p + 4.
template <int FORM>
__device__ __forceinline__ void tile_of(int w, int i, int& ra, int& cb) {
  if (FORM == GENERAL) {
    ra = w;
    cb = i;
  } else {
    const int p = w & 3, first = 2 * p + 2, x = 9 * (w >> 2) + i;
    ra = x < first ? p : 7 - p;
    cb = x < first ? x : x - first;
  }
}

template <int FORM>
using Acc = double[NTILES<FORM>][4];

// acc <- the tiles of a row-major 128x128 block in global memory
template <int FORM>
__device__ __forceinline__ void acc_load(Acc<FORM>& acc,
                                         const double* __restrict__ G,
                                         int tid) {
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
#pragma unroll
  for (int i = 0; i < NTILES<FORM>; ++i) {
    int ra, cb;
    tile_of<FORM>(warp, i, ra, cb);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const double2 v = __ldg(reinterpret_cast<const double2*>(
          G + (16 * ra + g + 8 * h) * B + 8 * cb + 2 * t));
      acc[i][2 * h] = v.x;
      acc[i][2 * h + 1] = v.y;
    }
  }
}

// S <- acc, between two barriers: every earlier read of S (and of the
// ring) is done before, and the block is whole after.
template <int FORM>
__device__ __forceinline__ void acc_to_shared(double* S, const Acc<FORM>& acc,
                                              int tid) {
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NTILES<FORM>; ++i) {
    int ra, cb;
    tile_of<FORM>(warp, i, ra, cb);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<double2*>(S + (16 * ra + g + 8 * h) * LD + 8 * cb +
                                  2 * t) =
          make_double2(acc[i][2 * h], acc[i][2 * h + 1]);
  }
  __syncthreads();
}

// acc += A B^T over the 128-deep contraction, a stage of BK at a time.
//   A: ag, row-major 128x128 in global, column k scaled by d[k]: acc -=
//      (A diag(d)) B^T; or, with ag == nullptr, S in shared memory: acc +=
//      S B^T, and dsc <- 1 / d for the caller.
//   B: bg, row-major 128x128 in global; with bg == ag (the Schur update) a
//      stage holds one slab that serves both operands.
//   CLIP: B is unit lower (a Dinv): column tile cb needs k <= 8 cb + 7, so
//      the 8-deep step k8 skips the tiles with cb < k8.
// ag, bg and d were written by this CTA before a block barrier.
template <int FORM, bool CLIP>
__device__ __forceinline__ void product(Acc<FORM>& acc, const double* ag,
                                        const double* bg,
                                        const double* d, const double* S,
                                        double* R, double* dsc, int tid) {
  constexpr int NRA = FORM == GENERAL ? 1 : 2;   // row blocks of a warp
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const bool same = ag == bg;
  __syncthreads();   // the ring and dsc are free
  if (d != nullptr)
    for (int e = tid; e < B; e += NT)
      dsc[e] = ag != nullptr ? -__ldcg(d + e) : leaf::recip(__ldcg(d + e));
  auto load = [&](int stage, int kc) {
    double* st = R + stage * STAGE;
#pragma unroll
    for (int c = tid; c < B * BK / 2; c += NT) {
      const int x = c / (BK / 2), k = (c % (BK / 2)) * 2;
      const long long src = (long long)x * B + kc * BK + k;
      if (ag != nullptr && !same) mma::cp16(st + slot(x, k), ag + src, 16);
      mma::cp16(st + OPND + slot(x, k), bg + src, 16);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    load(s, s);
    mma::commit();
  }
#pragma unroll 1
  for (int kc = 0; kc < NK; ++kc) {
    mma::wait_groups<STAGES - 2>();
    __syncthreads();   // stage kc is in; stage kc - 1 is free for all
    if (kc + STAGES - 1 < NK) load((kc + STAGES - 1) % STAGES, kc + STAGES - 1);
    mma::commit();
    const double* bs = R + (kc % STAGES) * STAGE + OPND;
    const double* as = same ? bs : bs - OPND;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      const int k8 = (kc * BK + kk) / 8;    // this 8-deep step of the 128
      double af[NRA][4];
#pragma unroll
      for (int r = 0; r < NRA; ++r) {
        const int x = 16 * (FORM == GENERAL ? warp
                            : r == 0         ? (warp & 3)
                                             : 7 - (warp & 3)) + g;
        double2 lo, hi;
        if (ag != nullptr) {
          lo = *reinterpret_cast<const double2*>(as + slot(x, kk + 2 * t));
          hi = *reinterpret_cast<const double2*>(as +
                                                 slot(x + 8, kk + 2 * t));
          const double2 s =
              *reinterpret_cast<const double2*>(dsc + 8 * k8 + 2 * t);
          lo.x *= s.x;
          lo.y *= s.y;
          hi.x *= s.x;
          hi.y *= s.y;
        } else {
          lo = *reinterpret_cast<const double2*>(S + x * LD + 8 * k8 + 2 * t);
          hi = *reinterpret_cast<const double2*>(S + (x + 8) * LD + 8 * k8 +
                                                 2 * t);
        }
        af[r][0] = lo.x;
        af[r][1] = hi.x;
        af[r][2] = lo.y;
        af[r][3] = hi.y;
      }
#pragma unroll
      for (int i = 0; i < NTILES<FORM>; ++i) {
        int ra, cb;
        tile_of<FORM>(warp, i, ra, cb);
        if (CLIP && cb < k8) continue;
        const double2 v = *reinterpret_cast<const double2*>(
            bs + slot(8 * cb + g, kk + 2 * t));
        const double bf[2] = {v.x, v.y};
        const bool second = NRA == 2 && ra != (warp & 3);
        double a4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          a4[e] = second ? af[NRA - 1][e] : af[0][e];
        mma::mma16x8x8(acc[i], a4, bf);
      }
    }
  }
  mma::wait_groups<0>();
}

template <int BW>
__global__ void __launch_bounds__(NT, 1)
band_factor_bw_kernel(const double* __restrict__ Kd,
                      const double* __restrict__ Ksubs, double* Lout,
                      double* Dinv, double* dout, int nb) {
  extern __shared__ __align__(16) double smem[];
  double* S = smem;               // B x LD
  double* R = S + B * LD;         // the operand ring; the leaf's W
  double* dcur = R + RING;        // d_k, then the leaf's 1 / d_k over dsc
  double* dsc = dcur + B;         // -d of a product's left operand

  const int tid = threadIdx.x;
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const size_t blk = (size_t)B * B;
  const size_t lane = blockIdx.x;
  const double* Kd_l = Kd + lane * nb * blk;
  const double* Ks_l = Ksubs + lane * nb * BW * blk;
  double* L_l = Lout + lane * nb * BW * blk;
  double* Dinv_l = Dinv + lane * nb * blk;
  double* d_l = dout + lane * nb * B;
  auto Lb = [&](int row, int j) { return L_l + ((size_t)row * BW + j - 1) * blk; };

#pragma unroll 1
  for (int k = 0; k < nb; ++k) {
#pragma unroll 1
    for (int j = BW; j >= 1; --j) {
      double* Lkj = Lb(k, j);
      if (k < j) {
        for (int e = tid; e < B * B; e += NT) Lkj[e] = 0.0;
      } else {
        Acc<GENERAL> acc;
        acc_load<GENERAL>(acc, Ks_l + ((size_t)k * BW + j - 1) * blk, tid);
#pragma unroll 1
        for (int q = j + 1; q <= BW; ++q)
          if (k >= q)
            product<GENERAL, false>(acc, Lb(k, q), Lb(k - j, q - j),
                                    d_l + (size_t)(k - q) * B, S, R, dsc,
                                    tid);
        acc_to_shared<GENERAL>(S, acc, tid);
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = 0.0;
        product<GENERAL, true>(acc, nullptr, Dinv_l + (size_t)(k - j) * blk,
                               d_l + (size_t)(k - j) * B, S, R, dsc, tid);
        // L[k, k-j] = (S Dinv^T) / d_{k-j}, the quotients from 1 / d
        const double* dj = d_l + (size_t)(k - j) * B;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int c = 8 * i + 2 * t;
          const double2 dv = __ldcg(reinterpret_cast<const double2*>(dj + c));
          const double2 rv = *reinterpret_cast<const double2*>(dsc + c);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<double2*>(Lkj + (16 * warp + g + 8 * h) * B +
                                        c) =
                make_double2(leaf::quot(acc[i][2 * h], dv.x, rv.x),
                             leaf::quot(acc[i][2 * h + 1], dv.y, rv.y));
        }
      }
      __syncthreads();  // L[k, k-j] is whole before the next product reads it
    }

    // Schur update of the diagonal block (lower tiles), then the leaf
    {
      Acc<LOWER> acc;
      acc_load<LOWER>(acc, Kd_l + (size_t)k * blk, tid);
#pragma unroll 1
      for (int q = 1; q <= BW; ++q)
        if (k >= q)
          product<LOWER, false>(acc, Lb(k, q), Lb(k, q),
                                d_l + (size_t)(k - q) * B, S, R, dsc, tid);
      acc_to_shared<LOWER>(S, acc, tid);
    }
    leaf::eliminate(S, R, dcur, tid);
    leaf::unit_lower_inv(S, R, tid);
    leaf::store_inverse(S, Dinv_l + (size_t)k * blk, B, tid);
    for (int j = tid; j < B; j += NT) d_l[(size_t)k * B + j] = dcur[j];
    __syncthreads();  // Dinv_k and d_k are whole before block row k + 1
  }
}

constexpr size_t SMEM_BYTES = (size_t)(B * LD + RING + 2 * B) * sizeof(double);

template <int BW>
int launch(const double* Kd, const double* Ksubs, double* L, double* Dinv,
           double* d, int lanes, int nb, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      band_factor_bw_kernel<BW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  band_factor_bw_kernel<BW><<<lanes, NT, SMEM_BYTES, stream>>>(Kd, Ksubs, L,
                                                               Dinv, d, nb);
  return (int)cudaGetLastError();
}

}  // namespace

// Kd: (lanes, nb, 128, 128) f64; Ksubs: (lanes, nb, bw, 128, 128) f64 with
// Ksubs[k][j-1] = K[k, k-j]; L: (lanes, nb, bw, 128, 128) f64 out; Dinv:
// (lanes, nb, 128, 128) f64 out; d: (lanes, nb, 128) f64 out; 1 <= bw <= 6.
// Every array 16-byte aligned.  Launches on `stream`; returns the CUDA
// error code of the launch (0 on success, cudaErrorInvalidValue for a
// bandwidth out of range).
extern "C" int eicos_band_factor_bw(const double* Kd, const double* Ksubs,
                                    double* L, double* Dinv, double* d,
                                    int lanes, int nb, int bw, void* stream) {
  static_assert(BW_MAX == 6, "one case per bandwidth below");
  cudaStream_t s = (cudaStream_t)stream;
  switch (bw) {
    case 1: return launch<1>(Kd, Ksubs, L, Dinv, d, lanes, nb, s);
    case 2: return launch<2>(Kd, Ksubs, L, Dinv, d, lanes, nb, s);
    case 3: return launch<3>(Kd, Ksubs, L, Dinv, d, lanes, nb, s);
    case 4: return launch<4>(Kd, Ksubs, L, Dinv, d, lanes, nb, s);
    case 5: return launch<5>(Kd, Ksubs, L, Dinv, d, lanes, nb, s);
    case 6: return launch<6>(Kd, Ksubs, L, Dinv, d, lanes, nb, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
