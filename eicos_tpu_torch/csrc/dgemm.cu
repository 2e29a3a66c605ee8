// dgemm: lane-batched f64 C = alpha * A @ B + beta * C with strided
// operands.
//
// Replaces the double-single GEMM kernels of eicos_tpu/ops/pallas_gemm_ds.py:
// the lane-tiled _make_bmm_kernel (via _bmm_call / _bmatmul_ds, the form of
// matmul_ds under the solver's lane vmap when both operands are per lane)
// and _gemv_kernel / _gemv_kernel_cached (via _gemv_call, matmul_ds and
// BigOperand.rmatmul with one shared right operand).  Those split each f64
// operand into (hi, lo) f32 pairs, chunk them to bf16 and fold the partial
// products with TwoSum; this kernel multiplies in native IEEE f64.  A shared
// operand is a lane stride of 0, so both TPU kernels are this one kernel.
//
// Operand element (l, i, j) lives at ptr[l*s_lane + i*s_row + j*s_col], so
// a transposed view (L11inv^T, L21^T in the dense recursion) is read in
// place and never copied; C needs s_col = 1 and may be a block of a larger
// matrix (the recursion writes L21inv straight into Linv).  With beta = 0,
// C is not read.  Ragged edges are masked.
//
// Bound: 2 r k n flops against 8 (r k + k n + 2 r n) bytes per lane, so at
// the dense recursion's sizes (k >= 128) it is bound by f64 operations.
//
// Design: a 64x64 tile of C per CTA, 256 threads with a 4x4 register tile
// each (rows ty + 16 r, columns tx + 16 c), and the contraction staged
// through shared memory in panels of 16: A's 64x16 panel and B's 16x64
// panel, each loaded along whichever of its axes is contiguous in memory,
// so that neighbouring threads read neighbouring addresses for plain and
// transposed views alike.  Plain FMA on the f64 pipes; no overlap of the
// next panel's loads with the current panel's FMAs.  DMMA (mma.sync f64),
// double buffering and TMA are later work.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int NT = 256;
constexpr int TM = BM / 16;   // rows per thread
constexpr int TN = BN / 16;   // columns per thread

__global__ void __launch_bounds__(NT)
dgemm_kernel(int M, int N, int K, double alpha,
             const double* __restrict__ A, long long a_lane, long long a_row,
             long long a_col, const double* __restrict__ Bm, long long b_lane,
             long long b_row, long long b_col, double beta,
             double* __restrict__ C, long long c_lane, long long c_row) {
  __shared__ double As[BK][BM + 1];
  __shared__ double Bs[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const long long lane = blockIdx.z;
  A += lane * a_lane;
  Bm += lane * b_lane;
  C += lane * c_lane;
  const bool a_rowmajor = a_col == 1;
  const bool b_rowmajor = b_col == 1;

  double acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.0;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int q = 0; q < BM * BK / NT; ++q) {
      const int e = tid + NT * q;
      const int i = a_rowmajor ? e / BK : e % BM;
      const int kk = a_rowmajor ? e % BK : e / BM;
      const int gi = i0 + i, gk = k0 + kk;
      As[kk][i] = (gi < M && gk < K) ? A[gi * a_row + gk * a_col] : 0.0;
    }
#pragma unroll
    for (int q = 0; q < BK * BN / NT; ++q) {
      const int e = tid + NT * q;
      const int j = b_rowmajor ? e % BN : e / BK;
      const int kk = b_rowmajor ? e / BN : e % BK;
      const int gj = j0 + j, gk = k0 + kk;
      Bs[kk][j] = (gj < N && gk < K) ? Bm[gk * b_row + gj * b_col] : 0.0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      double a[TM], b[TN];
#pragma unroll
      for (int r = 0; r < TM; ++r) a[r] = As[kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < TN; ++c) b[c] = Bs[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = fma(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int gi = i0 + ty + 16 * r;
    if (gi >= M) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int gj = j0 + tx + 16 * c;
      if (gj >= N) continue;
      double* p = C + gi * c_row + gj;
      *p = beta == 0.0 ? alpha * acc[r][c] : alpha * acc[r][c] + beta * *p;
    }
  }
}

}  // namespace

// C (lanes, M, N) = alpha * A (lanes, M, K) @ B (lanes, K, N) + beta * C,
// every operand addressed through its (lane, row, column) strides in
// elements (column stride 1 for C; lane stride 0 for a shared operand).
// Launches on `stream`; returns the CUDA error code of the launch.
extern "C" int eicos_dgemm(int lanes, int M, int N, int K, double alpha,
                           const double* A, long long a_lane, long long a_row,
                           long long a_col, const double* B, long long b_lane,
                           long long b_row, long long b_col, double beta,
                           double* C, long long c_lane, long long c_row,
                           void* stream) {
  if (lanes <= 0 || M <= 0 || N <= 0) return 0;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, lanes);
  dgemm_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      M, N, K, alpha, A, a_lane, a_row, a_col, B, b_lane, b_row, b_col, beta,
      C, c_lane, c_row);
  return (int)cudaGetLastError();
}
