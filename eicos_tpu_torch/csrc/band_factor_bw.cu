// band_factor_bw: block-banded LDL^T at block bandwidth bw = 1..6 of a batch
// of lanes, f64.
//
// Replaces the Pallas kernel _make_band_factor_bw (through band_factor_ds_bw)
// of eicos_tpu/ops/pallas_band_ds.py.  That kernel works on double-single
// pairs, balances every product by sqrt|d| (_bal_sub, to keep bf16 chunks in
// range) and carries the last bw rows' Dinv, d and bw^2 L blocks in VMEM
// rings.  This kernel computes the same object in native IEEE f64, without
// the balancing and without the rings.
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
// it at bw 1 and 2, operations from 3.  This kernel computes every product in
// full (bw (bw + 3) / 2 products of 2 x 128^3 a row).
//
// Design: one CTA per lane walks the block rows in order, as band_factor.cu
// does.  A 128x128 f64 block is 128 KB and a CTA has 227 KB of shared memory,
// so a ring of earlier L blocks cannot live there: the L, Dinv and d of the
// last bw rows are read back from the output arrays in global memory, which
// this CTA wrote itself (a __syncthreads() after the stores orders them, and
// the re-reads go through L2 with __ldcg).  Every product is C -= (A d) B^T or
// C += S B^T on an 8x8 register tile per thread, with the global operands
// streamed through two 128x32 shared panels and S, the one resident 128x128
// shared buffer (row stride 129), which afterwards holds M for the leaf
// (leaf.cuh, the device code band_factor.cu and leaf_ldl.cu run).  The
// bandwidth is a template parameter, so the loops over j and q are static.
// DMMA, TMA and several CTAs per lane are later work.

#include <cuda_runtime.h>

#include "leaf.cuh"

namespace {

constexpr int B = leaf::B;
constexpr int SLD = leaf::SLD;   // row stride of S
constexpr int NT = leaf::NT;     // threads per CTA (16 x 16 tiles of 8 x 8)
constexpr int PW = 32;           // panel width
constexpr int PLD = PW + 1;      // row stride of a panel
constexpr int BW_MAX = 6;

// acc -= (A diag(d)) Bm^T for row-major 128x128 blocks A, Bm and d (128) in
// global memory, all written earlier by this CTA.
__device__ __forceinline__ void sub_scaled_nt(double (&acc)[8][8],
                                              const double* A, const double* Bm,
                                              const double* d, double* PA,
                                              double* PB, int tid, int ti,
                                              int tj) {
  for (int p0 = 0; p0 < B; p0 += PW) {
    __syncthreads();
    for (int e = tid; e < B * PW; e += NT) {
      const int i = e / PW, t = e % PW;
      PA[i * PLD + t] = -__ldcg(A + i * B + p0 + t) * __ldcg(d + p0 + t);
      PB[i * PLD + t] = __ldcg(Bm + i * B + p0 + t);
    }
    __syncthreads();
#pragma unroll 2
    for (int t = 0; t < PW; ++t) {
      double a[8], b[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) a[r] = PA[(ti + 16 * r) * PLD + t];
#pragma unroll
      for (int c = 0; c < 8; ++c) b[c] = PB[(tj + 16 * c) * PLD + t];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fma(a[r], b[c], acc[r][c]);
    }
  }
}

// acc += S Bm^T for S in shared memory (row stride SLD) and a row-major
// 128x128 block Bm in global memory, written earlier by this CTA.
__device__ __forceinline__ void add_shared_nt(double (&acc)[8][8],
                                              const double* S, const double* Bm,
                                              double* PB, int tid, int ti,
                                              int tj) {
  for (int p0 = 0; p0 < B; p0 += PW) {
    __syncthreads();
    for (int e = tid; e < B * PW; e += NT) {
      const int i = e / PW, t = e % PW;
      PB[i * PLD + t] = __ldcg(Bm + i * B + p0 + t);
    }
    __syncthreads();
#pragma unroll 2
    for (int t = 0; t < PW; ++t) {
      double a[8], b[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) a[r] = S[(ti + 16 * r) * SLD + p0 + t];
#pragma unroll
      for (int c = 0; c < 8; ++c) b[c] = PB[(tj + 16 * c) * PLD + t];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fma(a[r], b[c], acc[r][c]);
    }
  }
}

__device__ __forceinline__ void load_tile(double (&acc)[8][8],
                                          const double* __restrict__ src, int ti,
                                          int tj) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      acc[r][c] = src[(ti + 16 * r) * B + tj + 16 * c];
}

// S <- acc, between two barriers: every earlier read of S is done before, and
// the block is whole after.
__device__ __forceinline__ void tile_to_shared(double* S,
                                               const double (&acc)[8][8],
                                               int ti, int tj) {
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      S[(ti + 16 * r) * SLD + tj + 16 * c] = acc[r][c];
  __syncthreads();
}

template <int BW>
__global__ void __launch_bounds__(NT, 1)
band_factor_bw_kernel(const double* __restrict__ Kd,
                      const double* __restrict__ Ksubs, double* Lout,
                      double* Dinv, double* dout, int nb) {
  extern __shared__ double smem[];
  double* S = smem;               // B x SLD
  double* PA = S + B * SLD;       // B x PLD
  double* PB = PA + B * PLD;      // B x PLD
  double* dcur = PB + B * PLD;    // d_k
  double* lvec = dcur + B;        // leaf column

  const int tid = threadIdx.x;
  const int ti = tid >> 4;        // tile row: rows ti + 16 r
  const int tj = tid & 15;        // tile col: cols tj + 16 c
  const size_t blk = (size_t)B * B;
  const size_t lane = blockIdx.x;
  const double* Kd_l = Kd + lane * nb * blk;
  const double* Ks_l = Ksubs + lane * nb * BW * blk;
  double* L_l = Lout + lane * nb * BW * blk;
  double* Dinv_l = Dinv + lane * nb * blk;
  double* d_l = dout + lane * nb * B;

  for (int k = 0; k < nb; ++k) {
    double acc[8][8];
#pragma unroll
    for (int j = BW; j >= 1; --j) {
      double* Lkj = L_l + ((size_t)k * BW + j - 1) * blk;
      if (k < j) {
        for (int e = tid; e < B * B; e += NT) Lkj[e] = 0.0;
      } else {
        load_tile(acc, Ks_l + ((size_t)k * BW + j - 1) * blk, ti, tj);
#pragma unroll
        for (int q = j + 1; q <= BW; ++q)
          if (k >= q)
            sub_scaled_nt(acc, L_l + ((size_t)k * BW + q - 1) * blk,
                          L_l + ((size_t)(k - j) * BW + q - j - 1) * blk,
                          d_l + (size_t)(k - q) * B, PA, PB, tid, ti, tj);
        tile_to_shared(S, acc, ti, tj);
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = 0.0;
        add_shared_nt(acc, S, Dinv_l + (size_t)(k - j) * blk, PB, tid, ti, tj);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const double dj = __ldcg(d_l + (size_t)(k - j) * B + tj + 16 * c);
#pragma unroll
          for (int r = 0; r < 8; ++r)
            Lkj[(ti + 16 * r) * B + tj + 16 * c] = acc[r][c] / dj;
        }
      }
      __syncthreads();  // L[k, k-j] is whole before the next product reads it
    }

    // Schur update of the diagonal block, then the leaf
    load_tile(acc, Kd_l + (size_t)k * blk, ti, tj);
#pragma unroll
    for (int q = 1; q <= BW; ++q)
      if (k >= q) {
        const double* Lkq = L_l + ((size_t)k * BW + q - 1) * blk;
        sub_scaled_nt(acc, Lkq, Lkq, d_l + (size_t)(k - q) * B, PA, PB, tid,
                      ti, tj);
      }
    tile_to_shared(S, acc, ti, tj);
    leaf::eliminate(S, dcur, lvec, tid);
    leaf::unit_lower_inv(S, tid);
    __syncthreads();
    double* Dk = Dinv_l + (size_t)k * blk;
    for (int e = tid; e < B * B; e += NT) {
      const int i = e / B, c = e % B;
      Dk[e] = i > c ? S[c * SLD + i] : (i == c ? 1.0 : 0.0);
    }
    for (int j = tid; j < B; j += NT) d_l[(size_t)k * B + j] = dcur[j];
    __syncthreads();  // Dinv_k and d_k are whole before block row k + 1
  }
}

constexpr size_t SMEM_BYTES =
    (size_t)(B * SLD + 2 * B * PLD + 2 * B) * sizeof(double);

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
// Launches on `stream`; returns the CUDA error code of the launch (0 on
// success, cudaErrorInvalidValue for a bandwidth out of range).
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
