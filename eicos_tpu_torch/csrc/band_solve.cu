// band_fwd / band_bwd: the two triangular sweeps of a block-tridiagonal
// (bwb = 1) LDL^T solve, for a batch of lanes and up to 16 right-hand sides.
//
// Replace the Pallas solve kernels of eicos_tpu/ops/pallas_band_ds.py:
// _fwd_kernel / _bwd_kernel (band_solve_ds), _fwd_kernel_pre /
// _bwd_kernel_pre (_band_solve_ds_pre_impl) and their lane-tiled forms
// _make_fwd_kernel_pre_b / _make_bwd_kernel_pre_b (_band_solve_pre_batch,
// the solver's path under vmap).  Those stream a double-single or chunked
// factor; these read the f64 factor of band_factor.cu directly.
//
//   band_fwd: y_k = Dinv_k (x_k - L_k y_{k-1}),  w_k = y_k / d_k
//   band_bwd: z_k = Dinv_k^T (w_k - L_{k+1}^T z_{k+1}),  k = nb-1 .. 0
//
// Right-hand sides keep the layout of eicos_tpu's band_solve_ds, (k, Dp) per
// lane: row `col` of lane `l` is rhs[(l * k + col) * Dp + row].
//
// Bound: each sweep needs the factor once, per lane and block row L (128 KB)
// and the lower triangle of the unit-lower Dinv (64.5 KB): 0.40 GB for the
// bench's 128 lanes x 16 block rows, for 2 x 128^2 x k FMAs per full block:
// at most 16 x 2 / 8 = 4 FLOP per byte, so the sweeps are bound by HBM bytes.
// These kernels read Dinv whole.
//
// Design: one CTA per lane walks the block rows in order (the carry y_{k-1}
// or z_{k+1} lives in shared memory).  Each 128x128 factor block is staged
// from HBM into shared memory with coalesced loads (row stride 129, so a
// thread walking a row or a column of the block hits distinct banks), then
// 256 threads compute one row and up to 8 right-hand sides each.  The
// staging is not overlapped with the arithmetic; a double-buffered cp.async
// or TMA pipeline, and several lanes per CTA so that small batches fill the
// card, are later work.

#include <cuda_runtime.h>

namespace {

constexpr int B = 128;
constexpr int SLD = B + 1;
constexpr int KP = 16;   // most right-hand sides per call
constexpr int NT = 256;
constexpr int CPT = KP / (NT / B);  // right-hand sides per thread

__device__ __forceinline__ void stage(double* T, const double* __restrict__ src,
                                      int tid) {
  const double2* s2 = reinterpret_cast<const double2*>(src);
#pragma unroll 8
  for (int e = tid; e < B * B / 2; e += NT) {
    const double2 v = s2[e];
    const int i = (2 * e) / B, j = (2 * e) % B;
    T[i * SLD + j] = v.x;
    T[i * SLD + j + 1] = v.y;
  }
}

// acc[row][col] <- rows of the current block of `src` (k rows of length Dp)
__device__ __forceinline__ void load_rhs(double* acc, const double* __restrict__ src,
                                         int Dp, int k, int b, int tid) {
  for (int e = tid; e < k * B; e += NT) {
    const int col = e / B, r = e % B;
    acc[r * KP + col] = src[(size_t)col * Dp + b * B + r];
  }
}

__global__ void __launch_bounds__(NT, 1)
band_fwd_kernel(const double* __restrict__ L, const double* __restrict__ Dinv,
                const double* __restrict__ d, const double* __restrict__ rhs,
                double* __restrict__ out, int nb, int k) {
  extern __shared__ double smem[];
  double* T = smem;           // staged factor block, B x SLD
  double* acc = T + B * SLD;  // B x KP
  double* y = acc + B * KP;   // carry y_{b-1}, B x KP

  const int tid = threadIdx.x;
  const int i = tid & (B - 1);
  const int cg = tid / B;
  const int Dp = nb * B;
  const size_t blk = (size_t)B * B;
  const size_t lane = blockIdx.x;
  const double* L_l = L + lane * nb * blk;
  const double* D_l = Dinv + lane * nb * blk;
  const double* d_l = d + lane * nb * B;
  const double* x_l = rhs + lane * k * Dp;
  double* o_l = out + lane * k * Dp;

  for (int b = 0; b < nb; ++b) {
    load_rhs(acc, x_l, Dp, k, b, tid);
    if (b > 0) {
      stage(T, L_l + b * blk, tid);
      __syncthreads();
      double s[CPT];
#pragma unroll
      for (int q = 0; q < CPT; ++q) s[q] = 0.0;
      for (int t = 0; t < B; ++t) {
        const double a = T[i * SLD + t];
#pragma unroll
        for (int q = 0; q < CPT; ++q) {
          const int col = cg + 2 * q;
          if (col < k) s[q] = fma(a, y[t * KP + col], s[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int col = cg + 2 * q;
        if (col < k) acc[i * KP + col] -= s[q];
      }
    }
    __syncthreads();
    stage(T, D_l + b * blk, tid);
    __syncthreads();
    double s[CPT];
#pragma unroll
    for (int q = 0; q < CPT; ++q) s[q] = 0.0;
    for (int t = 0; t < B; ++t) {
      const double a = T[i * SLD + t];
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int col = cg + 2 * q;
        if (col < k) s[q] = fma(a, acc[t * KP + col], s[q]);
      }
    }
    const double di = d_l[b * B + i];
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const int col = cg + 2 * q;
      if (col < k) {
        y[i * KP + col] = s[q];
        o_l[(size_t)col * Dp + b * B + i] = s[q] / di;
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NT, 1)
band_bwd_kernel(const double* __restrict__ L, const double* __restrict__ Dinv,
                const double* __restrict__ w, double* __restrict__ out, int nb,
                int k) {
  extern __shared__ double smem[];
  double* T = smem;
  double* acc = T + B * SLD;
  double* z = acc + B * KP;   // carry z_{b+1}

  const int tid = threadIdx.x;
  const int i = tid & (B - 1);
  const int cg = tid / B;
  const int Dp = nb * B;
  const size_t blk = (size_t)B * B;
  const size_t lane = blockIdx.x;
  const double* L_l = L + lane * nb * blk;
  const double* D_l = Dinv + lane * nb * blk;
  const double* w_l = w + lane * k * Dp;
  double* o_l = out + lane * k * Dp;

  for (int b = nb - 1; b >= 0; --b) {
    load_rhs(acc, w_l, Dp, k, b, tid);
    if (b < nb - 1) {
      stage(T, L_l + (b + 1) * blk, tid);
      __syncthreads();
      double s[CPT];
#pragma unroll
      for (int q = 0; q < CPT; ++q) s[q] = 0.0;
      for (int t = 0; t < B; ++t) {
        const double a = T[t * SLD + i];   // L_{b+1}^T
#pragma unroll
        for (int q = 0; q < CPT; ++q) {
          const int col = cg + 2 * q;
          if (col < k) s[q] = fma(a, z[t * KP + col], s[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int col = cg + 2 * q;
        if (col < k) acc[i * KP + col] -= s[q];
      }
    }
    __syncthreads();
    stage(T, D_l + b * blk, tid);
    __syncthreads();
    double s[CPT];
#pragma unroll
    for (int q = 0; q < CPT; ++q) s[q] = 0.0;
    for (int t = 0; t < B; ++t) {
      const double a = T[t * SLD + i];     // Dinv_b^T
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int col = cg + 2 * q;
        if (col < k) s[q] = fma(a, acc[t * KP + col], s[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const int col = cg + 2 * q;
      if (col < k) {
        z[i * KP + col] = s[q];
        o_l[(size_t)col * Dp + b * B + i] = s[q];
      }
    }
    __syncthreads();
  }
}

constexpr size_t SMEM_BYTES = (size_t)(B * SLD + 2 * B * KP) * sizeof(double);

}  // namespace

// L, Dinv: (lanes, nb, 128, 128) f64; d: (lanes, nb, 128) f64;
// rhs, out: (lanes, k, nb * 128) f64 with 1 <= k <= 16.
extern "C" int eicos_band_fwd(const double* L, const double* Dinv,
                              const double* d, const double* rhs, double* out,
                              int lanes, int nb, int k, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      band_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  band_fwd_kernel<<<lanes, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
      L, Dinv, d, rhs, out, nb, k);
  return (int)cudaGetLastError();
}

// L, Dinv as for eicos_band_fwd; w, out: (lanes, k, nb * 128) f64.
extern "C" int eicos_band_bwd(const double* L, const double* Dinv,
                              const double* w, double* out, int lanes, int nb,
                              int k, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      band_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  band_bwd_kernel<<<lanes, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
      L, Dinv, w, out, nb, k);
  return (int)cudaGetLastError();
}
