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
// at k = 16, so the sweeps are bound by HBM bytes.  These kernels read Dinv
// whole.
//
// Design: one CTA per lane walks the block rows in order.  The last bw y (or
// z) blocks live in a shared-memory ring (bw x 128 x 16 f64, 96 KB at bw = 6),
// slot k mod bw.  L[k+j, k] of the backward sweep is L[k+j][j-1], read
// straight from global memory, so the TPU kernel's L ring has no counterpart.
// A 128x128 factor block does not fit beside the ring, so each block streams
// through one 32-wide shared panel (128x32 forward, 32x128 backward for the
// transposed product), loaded coalesced and read along the padded axis
// without bank conflicts; 256 threads compute one row and up to 8 right-hand
// sides each.  The panel loads are not overlapped with the arithmetic; a
// cp.async or TMA pipeline and several lanes per CTA are later work.

#include <cuda_runtime.h>

namespace {

constexpr int B = 128;
constexpr int SLD = B + 1;
constexpr int KP = 16;   // most right-hand sides per call
constexpr int NT = 256;
constexpr int CPT = KP / (NT / B);  // right-hand sides per thread
constexpr int PW = 32;   // panel width
constexpr int PLD = PW + 1;
constexpr int BW_MAX = 6;
constexpr int PANEL = (B * PLD > PW * SLD) ? B * PLD : PW * SLD;

// acc[row][col] <- rows of block b of `src` (k rows of length Dp)
__device__ __forceinline__ void load_rhs(double* acc, const double* __restrict__ src,
                                         int Dp, int k, int b, int tid) {
  for (int e = tid; e < k * B; e += NT) {
    const int col = e / B, r = e % B;
    acc[r * KP + col] = src[(size_t)col * Dp + b * B + r];
  }
}

// s[q] = sum_t blk[i][t] v[t][col_q]: the block through 128 x PW panels
__device__ __forceinline__ void mv_n(double (&s)[CPT], const double* __restrict__ blk,
                                     const double* v, double* P, int k, int i,
                                     int cg, int tid) {
#pragma unroll
  for (int q = 0; q < CPT; ++q) s[q] = 0.0;
  for (int p0 = 0; p0 < B; p0 += PW) {
    __syncthreads();
    for (int e = tid; e < B * PW; e += NT) {
      const int r = e / PW, t = e % PW;
      P[r * PLD + t] = blk[r * B + p0 + t];
    }
    __syncthreads();
    for (int t = 0; t < PW; ++t) {
      const double a = P[i * PLD + t];
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int col = cg + 2 * q;
        if (col < k) s[q] = fma(a, v[(p0 + t) * KP + col], s[q]);
      }
    }
  }
}

// s[q] = sum_t blk[t][i] v[t][col_q]: the block through PW x 128 panels
__device__ __forceinline__ void mv_t(double (&s)[CPT], const double* __restrict__ blk,
                                     const double* v, double* P, int k, int i,
                                     int cg, int tid) {
#pragma unroll
  for (int q = 0; q < CPT; ++q) s[q] = 0.0;
  for (int p0 = 0; p0 < B; p0 += PW) {
    __syncthreads();
    for (int e = tid; e < PW * B; e += NT) {
      const int t = e / B, c = e % B;
      P[t * SLD + c] = blk[(p0 + t) * B + c];
    }
    __syncthreads();
    for (int t = 0; t < PW; ++t) {
      const double a = P[t * SLD + i];
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int col = cg + 2 * q;
        if (col < k) s[q] = fma(a, v[(p0 + t) * KP + col], s[q]);
      }
    }
  }
}

__global__ void __launch_bounds__(NT, 1)
band_fwd_bw_kernel(const double* __restrict__ L, const double* __restrict__ Dinv,
                   const double* __restrict__ d, const double* __restrict__ rhs,
                   double* __restrict__ out, int nb, int bw, int k) {
  extern __shared__ double smem[];
  double* P = smem;              // one panel
  double* acc = P + PANEL;       // B x KP
  double* ring = acc + B * KP;   // bw x (B x KP): y_{b-1} .. y_{b-bw}

  const int tid = threadIdx.x;
  const int i = tid & (B - 1);
  const int cg = tid / B;
  const int Dp = nb * B;
  const size_t blk = (size_t)B * B;
  const size_t lane = blockIdx.x;
  const double* L_l = L + lane * nb * bw * blk;
  const double* D_l = Dinv + lane * nb * blk;
  const double* d_l = d + lane * nb * B;
  const double* x_l = rhs + lane * k * Dp;
  double* o_l = out + lane * k * Dp;

  for (int b = 0; b < nb; ++b) {
    load_rhs(acc, x_l, Dp, k, b, tid);
    const int jmax = b < bw ? b : bw;
    double s[CPT];
    for (int j = 1; j <= jmax; ++j) {
      mv_n(s, L_l + ((size_t)b * bw + j - 1) * blk,
           ring + ((b - j) % bw) * B * KP, P, k, i, cg, tid);
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int col = cg + 2 * q;
        if (col < k) acc[i * KP + col] -= s[q];
      }
    }
    mv_n(s, D_l + (size_t)b * blk, acc, P, k, i, cg, tid);
    double* y = ring + (b % bw) * B * KP;
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
band_bwd_bw_kernel(const double* __restrict__ L, const double* __restrict__ Dinv,
                   const double* __restrict__ w, double* __restrict__ out,
                   int nb, int bw, int k) {
  extern __shared__ double smem[];
  double* P = smem;
  double* acc = P + PANEL;
  double* ring = acc + B * KP;   // z_{b+1} .. z_{b+bw}

  const int tid = threadIdx.x;
  const int i = tid & (B - 1);
  const int cg = tid / B;
  const int Dp = nb * B;
  const size_t blk = (size_t)B * B;
  const size_t lane = blockIdx.x;
  const double* L_l = L + lane * nb * bw * blk;
  const double* D_l = Dinv + lane * nb * blk;
  const double* w_l = w + lane * k * Dp;
  double* o_l = out + lane * k * Dp;

  for (int b = nb - 1; b >= 0; --b) {
    load_rhs(acc, w_l, Dp, k, b, tid);
    const int jmax = nb - 1 - b < bw ? nb - 1 - b : bw;
    double s[CPT];
    for (int j = 1; j <= jmax; ++j) {
      mv_t(s, L_l + ((size_t)(b + j) * bw + j - 1) * blk,   // L[b+j, b]
           ring + ((b + j) % bw) * B * KP, P, k, i, cg, tid);
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int col = cg + 2 * q;
        if (col < k) acc[i * KP + col] -= s[q];
      }
    }
    mv_t(s, D_l + (size_t)b * blk, acc, P, k, i, cg, tid);
    double* z = ring + (b % bw) * B * KP;
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

size_t smem_bytes(int bw) {
  return (size_t)(PANEL + B * KP + bw * B * KP) * sizeof(double);
}

}  // namespace

// L: (lanes, nb, bw, 128, 128) f64 with L[k][j-1] = L[k, k-j]; Dinv: (lanes,
// nb, 128, 128) f64; d: (lanes, nb, 128) f64; rhs, out: (lanes, k, nb * 128)
// f64 with 1 <= k <= 16 and 1 <= bw <= 6.  Returns the CUDA error code of the
// launch (0 on success, cudaErrorInvalidValue for a bandwidth out of range).
extern "C" int eicos_band_fwd_bw(const double* L, const double* Dinv,
                                 const double* d, const double* rhs,
                                 double* out, int lanes, int nb, int bw, int k,
                                 void* stream) {
  if (bw < 1 || bw > BW_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      band_fwd_bw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(BW_MAX));
  if (err != cudaSuccess) return (int)err;
  band_fwd_bw_kernel<<<lanes, NT, smem_bytes(bw), (cudaStream_t)stream>>>(
      L, Dinv, d, rhs, out, nb, bw, k);
  return (int)cudaGetLastError();
}

// L, Dinv as for eicos_band_fwd_bw; w, out: (lanes, k, nb * 128) f64.
extern "C" int eicos_band_bwd_bw(const double* L, const double* Dinv,
                                 const double* w, double* out, int lanes,
                                 int nb, int bw, int k, void* stream) {
  if (bw < 1 || bw > BW_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      band_bwd_bw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(BW_MAX));
  if (err != cudaSuccess) return (int)err;
  band_bwd_bw_kernel<<<lanes, NT, smem_bytes(bw), (cudaStream_t)stream>>>(
      L, Dinv, w, out, nb, bw, k);
  return (int)cudaGetLastError();
}
