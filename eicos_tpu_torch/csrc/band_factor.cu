// band_factor: block-tridiagonal (bwb = 1) LDL^T of a batch of lanes, f64.
//
// Replaces the Pallas band factor kernels of eicos_tpu/ops/pallas_band_ds.py:
// _band_factor_kernel (single lane, via _band_factor_ds_impl), the lane-tiled
// _make_band_factor_tiled_pre (via _band_factor_pre_batch, the solver's path
// under vmap) and _make_band_factor_tiled (via _band_factor_ds_batch).  All
// three compute the same object in double-single arithmetic; this kernel
// computes it in native IEEE f64 and emits no chunk decomposition.
//
// Per lane, for block rows k = 0..nb-1 (B = 128):
//   L_k    = Ks_k Dinv_{k-1}^T / d_{k-1}           (L_0 = 0, Ks_0 never read:
//                                                  it is the scatter's dump slot)
//   M      = Kd_k - (L_k d_{k-1}) L_k^T
//   M      = Lkk diag(d_k) Lkk^T, unpivoted, |d| clamped to >= 1e-150
//   Dinv_k = Lkk^{-1}
//
// Bound: per block row the function needs two 128^3 products of which half
// the operations are needed (L_k against a unit-lower Dinv, and a symmetric
// Schur update of which the leaf reads the lower triangle), the leaf
// elimination and the unit-lower inverse: ~6 MFLOP, against 4 x 128 KB of HBM
// traffic (read Kd_k, Ks_k; write L_k, Dinv_k).  At ~11 FLOP per byte the
// work sits below the H100's f64 balance point (67 TFLOP/s over 3.35 TB/s is
// 20), so bytes bound it; what bounds this design is the strict sequence of
// a lane's block rows and the leaf's 256 barriers.  This kernel computes
// both products in full.
//
// Design: one CTA per lane (the bench batch is 128 lanes on 132 SMs) walks
// the block rows in order; a CTA cannot share a carry with another, since
// Hopper runs blocks in no order.  One 128x128 f64 buffer S (row stride 129,
// so column walks hit distinct banks) lives in dynamic shared memory for the
// whole lane and carries the factor from one block row to the next:
//   * after block row k-1, S holds Dinv_{k-1}^T in its strict upper triangle;
//     the L_k product reads it there, with Ks_k streamed through a 128x32
//     shared panel;
//   * L_k is written to HBM and into S; the Schur product reads both
//     operands from S, and its result minus Kd_k becomes M in S;
//   * the leaf (leaf.cuh, shared with leaf_ldl.cu) eliminates M in place
//     (lower triangle), 128 steps of a rank-1 update with two barriers
//     each, and forms the unit-lower inverse column by column into the
//     strict upper triangle of S (as Dinv^T), two threads per column joined
//     by a warp shuffle, with no block barrier.
// Products are plain f64 FMA loops over an 8x8 register tile per thread.
// DMMA (mma.sync f64), a blocked leaf and TMA are later work.

#include <cuda_runtime.h>

#include "leaf.cuh"

namespace {

constexpr int B = leaf::B;
constexpr int SLD = leaf::SLD;   // row stride of S
constexpr int PW = 32;       // Ks panel width
constexpr int PLD = PW + 1;  // row stride of the panel
constexpr int NT = leaf::NT;  // threads per CTA (16 x 16 tiles of 8 x 8)

__global__ void __launch_bounds__(NT, 1)
band_factor_kernel(const double* __restrict__ Kd,
                   const double* __restrict__ Ks,
                   double* __restrict__ Lout,
                   double* __restrict__ Dinv,
                   double* __restrict__ dout, int nb) {
  extern __shared__ double smem[];
  double* S = smem;               // B x SLD
  double* P = S + B * SLD;        // B x PLD
  double* dprev = P + B * PLD;    // d_{k-1}
  double* dcur = dprev + B;       // d_k
  double* lvec = dcur + B;        // leaf column

  const int tid = threadIdx.x;
  const int ti = tid >> 4;        // tile row: rows ti + 16 r
  const int tj = tid & 15;        // tile col: cols tj + 16 c
  const size_t blk = (size_t)B * B;
  const size_t lane_off = (size_t)blockIdx.x * nb * blk;
  const double* Kd_l = Kd + lane_off;
  const double* Ks_l = Ks + lane_off;
  double* L_l = Lout + lane_off;
  double* Dinv_l = Dinv + lane_off;
  double* d_l = dout + (size_t)blockIdx.x * nb * B;

  for (int k = 0; k < nb; ++k) {
    const double* Kdk = Kd_l + k * blk;
    double* Lk = L_l + k * blk;
    double acc[8][8];

    if (k == 0) {
      for (int e = tid; e < B * B; e += NT) {
        Lk[e] = 0.0;
        S[(e / B) * SLD + e % B] = Kdk[e];
      }
      __syncthreads();
    } else {
      const double* Ksk = Ks_l + k * blk;
      // complete Dinv_{k-1}^T in S: unit diagonal, zero strict lower
      for (int e = tid; e < B * B; e += NT) {
        const int i = e / B, j = e % B;
        if (i >= j) S[i * SLD + j] = (i == j) ? 1.0 : 0.0;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.0;
      // acc = Ks_k Dinv_{k-1}^T, Ks_k through the panel
      for (int p0 = 0; p0 < B; p0 += PW) {
        __syncthreads();
        for (int e = tid; e < B * PW; e += NT) {
          const int i = e / PW, t = e % PW;
          P[i * PLD + t] = Ksk[i * B + p0 + t];
        }
        __syncthreads();
#pragma unroll 2
        for (int t = 0; t < PW; ++t) {
          double a[8], b[8];
#pragma unroll
          for (int r = 0; r < 8; ++r) a[r] = P[(ti + 16 * r) * PLD + t];
#pragma unroll
          for (int c = 0; c < 8; ++c) b[c] = S[(p0 + t) * SLD + tj + 16 * c];
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[r][c] = fma(a[r], b[c], acc[r][c]);
        }
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const double dj = dprev[tj + 16 * c];
#pragma unroll
        for (int r = 0; r < 8; ++r) acc[r][c] = acc[r][c] / dj;
      }
      __syncthreads();  // all reads of Dinv_{k-1}^T done
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int i = ti + 16 * r, j = tj + 16 * c;
          S[i * SLD + j] = acc[r][c];
          Lk[i * B + j] = acc[r][c];
        }
      __syncthreads();
      // Schur: acc = (L_k d_{k-1}) L_k^T
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.0;
#pragma unroll 2
      for (int t = 0; t < B; ++t) {
        const double dt = dprev[t];
        double a[8], b[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) a[r] = S[(ti + 16 * r) * SLD + t] * dt;
#pragma unroll
        for (int c = 0; c < 8; ++c) b[c] = S[(tj + 16 * c) * SLD + t];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fma(a[r], b[c], acc[r][c]);
      }
      __syncthreads();  // all reads of L_k done
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int i = ti + 16 * r, j = tj + 16 * c;
          S[i * SLD + j] = Kdk[i * B + j] - acc[r][c];
        }
      __syncthreads();
    }

    // leaf: unpivoted LDL^T of M, lower triangle of S, in place; then the
    // unit-lower inverse as Dinv_k^T in the strict upper triangle
    leaf::eliminate(S, dcur, lvec, tid);
    leaf::unit_lower_inv(S, tid);
    __syncthreads();
    double* Dk = Dinv_l + k * blk;
    for (int e = tid; e < B * B; e += NT) {
      const int i = e / B, c = e % B;
      Dk[e] = i > c ? S[c * SLD + i] : (i == c ? 1.0 : 0.0);
    }
    for (int j = tid; j < B; j += NT) {
      d_l[k * B + j] = dcur[j];
      dprev[j] = dcur[j];
    }
    __syncthreads();
  }
}

constexpr size_t SMEM_BYTES = (size_t)(B * SLD + B * PLD + 3 * B) * sizeof(double);

}  // namespace

// Kd, Ks: (lanes, nb, 128, 128) f64; L, Dinv: (lanes, nb, 128, 128) f64 out;
// d: (lanes, nb, 128) f64 out.  Launches on `stream`; returns the CUDA error
// code of the launch (0 on success).
extern "C" int eicos_band_factor(const double* Kd, const double* Ks, double* L,
                                 double* Dinv, double* d, int lanes, int nb,
                                 void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      band_factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  band_factor_kernel<<<lanes, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
      Kd, Ks, L, Dinv, d, nb);
  return (int)cudaGetLastError();
}
