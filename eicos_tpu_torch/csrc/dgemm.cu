// dgemm: lane-batched f64 C = alpha * A @ B + beta * C with strided
// operands, on the f64 tensor cores.
//
// Replaces the double-single GEMM kernels of eicos_tpu/ops/pallas_gemm_ds.py:
// the lane-tiled _make_bmm_kernel (via _bmm_call / _bmatmul_ds, the form of
// matmul_ds under the solver's lane vmap when both operands are per lane)
// and _gemv_kernel / _gemv_kernel_cached (via _gemv_call, matmul_ds and
// BigOperand.rmatmul with one shared right operand).  Those split each f64
// operand into (hi, lo) f32 pairs, chunk them to bf16 and fold the partial
// products with TwoSum; this kernel multiplies in native IEEE f64.  A shared
// operand is a lane stride of 0, so both TPU kernels are this one kernel
// (the wrapper folds a shared right operand's lanes into M where A's lanes
// follow one another, so B is read once).
//
// Operand element (l, i, j) lives at ptr[l*s_lane + i*s_row + j*s_col], so
// a transposed view (L11inv^T, L21^T in the dense recursion) is read in
// place and never copied; C needs s_col = 1 and may be a block of a larger
// matrix (the recursion writes L21inv straight into Linv).  With beta = 0,
// C is not read.  Ragged edges are masked.
//
// Bound: 2 r k n flops against 8 (r k + k n + 2 r n) bytes per lane, so at
// the dense recursion's sizes (k >= 128) it is bound by f64 operations:
// Hopper's f64 rate (67 TFLOP/s) is reached only through the tensor cores
// (DMMA; wgmma has no f64 type): the FMA pipes give half of it.
//
// Design:
// - mma.sync m16n8k8 f64 (sm_90), 2048 flops an instruction.  A CTA of 8
//   warps computes a 128x128 tile of C; each warp a 64x32 block, 4x4 MMA
//   tiles, 64 accumulators a thread.
// - The contraction runs through a ring of STAGES = 2 cp.async stages of
//   depth BK = 32 in dynamic shared memory (160 KB), one __syncthreads() a
//   stage, the next stage's loads in flight while the tensor cores work on
//   this one.  Timed side by side on the H100, this beat 4 stages of depth
//   16 by 4-6 % (PERF.md); 3 stages of depth 32 do not fit.
//   Each operand is copied along whichever of its axes is contiguous in
//   memory, 16 bytes a thread where the operand is 16-byte aligned and 8
//   bytes (zero-filled past the edge) otherwise, and kept in shared memory
//   in that orientation.  A thread's two k-slots of an MMA take adjacent
//   contraction indices, so a K-contiguous operand gives both in one
//   16-byte load.  Rows of BK + 8 (K contiguous) or 128 + 2 doubles keep
//   the fragment loads free of bank conflicts.
// - No work on known zeros (flags): with a triangular A or B each C tile
//   clips its contraction range to where the operand can be nonzero, and
//   with a lower-only C (the symmetric Schur update, of which only the
//   lower triangle is read again) tiles strictly above the diagonal exit at
//   once and diagonal tiles write only j <= i.  The zeros the clip skips
//   are exact, so the result is the full product's up to summation order.
// - Each C element is summed by one thread in one fixed order (no split-K,
//   no atomics): a repeated call gives the same bits.

#include <cuda_runtime.h>

#include "mma_f64.cuh"

namespace {

using mma::commit;
using mma::cp16;
using mma::cp8;
using mma::mma16x8x8;
using mma::wait_groups;

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int STAGES = 2;
constexpr int NT = 256;
constexpr int LDK = BK + 8;    // a K-contiguous operand: rows of BK
// an M- (or N-) contiguous tile of ROWS rows (of A) or columns (of B):
// rows of ROWS + 2; a stage of it, in doubles
template <int ROWS>
constexpr int LDX = ROWS + 2;
template <int ROWS>
constexpr int STAGE = ROWS * LDK > BK * LDX<ROWS> ? ROWS * LDK
                                                  : BK * LDX<ROWS>;
constexpr int OPA = STAGE<BM>, OPB = STAGE<BN>;
constexpr int WM = 64, WN = 32;          // warp tile
constexpr int MT = WM / 16, NTL = WN / 8;

// flag bits (ops/gemm.py)
constexpr int C_LOWER = 1;
constexpr int A_LOWER = 2, A_UPPER = 4, B_LOWER = 8, B_UPPER = 16;

// One operand tile, ROWS (outer: rows of A or columns of B) x BK, into S.
// Element (x, k) of the operand is at g[x * s_x + k * s_k]; x < nx and
// k < nk are in range, the rest is zero-filled.  KC: K is the contiguous
// axis (s_k == 1, S[x * LDK + k]); else x is (s_x == 1, S[k * LDX + x]),
// or neither is and the tile is copied element by element.  vec: 16-byte
// copies (the operand is 16-byte aligned along its contiguous axis).
template <bool KC, int ROWS>
__device__ __forceinline__ void load_tile(double* S, const double* g,
                                          long long s_x, long long s_k,
                                          int x0, int nx, int k0, int nk,
                                          bool vec, int tid) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < ROWS * BK / 2 / NT; ++q) {
      const int c = tid + NT * q;
      int x, k;
      if (KC) {
        x = c / (BK / 2);
        k = (c % (BK / 2)) * 2;
      } else {
        k = c / (ROWS / 2);
        x = (c % (ROWS / 2)) * 2;
      }
      const int gx = x0 + x, gk = k0 + k;
      int n = KC ? nk - gk : nx - gx;
      n = n < 0 ? 0 : (n > 2 ? 2 : n);
      if ((KC ? gx >= nx : gk >= nk)) n = 0;
      const double* src = n ? g + (long long)gx * s_x + (long long)gk * s_k : g;
      cp16(KC ? S + x * LDK + k : S + k * LDX<ROWS> + x, src, 8 * n);
    }
  } else {
#pragma unroll 4
    for (int q = 0; q < ROWS * BK / NT; ++q) {
      const int c = tid + NT * q;
      int x, k;
      if (KC) {
        x = c / BK;
        k = c % BK;
      } else {
        k = c / ROWS;
        x = c % ROWS;
      }
      const int gx = x0 + x, gk = k0 + k;
      const bool in = gx < nx && gk < nk;
      const double* src = in ? g + (long long)gx * s_x + (long long)gk * s_k : g;
      cp8(KC ? S + x * LDK + k : S + k * LDX<ROWS> + x, src, in ? 8 : 0);
    }
  }
}

template <bool KC, int ROWS>
__device__ __forceinline__ double2 frag2(const double* S, int x, int k) {
  return mma::frag2<KC, LDK, LDX<ROWS>>(S, x, k);
}

template <bool AK, bool BKC>
__global__ void __launch_bounds__(NT, 1)
dgemm_kernel(int M, int N, int K, double alpha, const double* __restrict__ A,
             long long a_lane, long long a_row, long long a_col, bool a_vec,
             const double* __restrict__ Bm, long long b_lane, long long b_row,
             long long b_col, bool b_vec, double beta, double* __restrict__ C,
             long long c_lane, long long c_row, int flags) {
  extern __shared__ double smem[];
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  if ((flags & C_LOWER) && j0 > i0 + BM - 1) return;   // above the diagonal

  // the contraction range this tile needs
  int kb = 0, ke = K;
  if (flags & A_LOWER) ke = min(ke, i0 + BM);
  if (flags & A_UPPER) kb = max(kb, i0);
  if (flags & B_LOWER) kb = max(kb, j0);
  if (flags & B_UPPER) ke = min(ke, j0 + BN);
  const int kt0 = kb / BK;
  const int ntiles = ke > kb ? (ke + BK - 1) / BK - kt0 : 0;

  const int tid = threadIdx.x;
  const int lane_id = tid & 31, warp = tid >> 5;
  const int g = lane_id >> 2, t = lane_id & 3;
  const int wm = (warp / (BN / WN)) * WM, wn = (warp % (BN / WN)) * WN;
  const long long l = blockIdx.z;
  A += l * a_lane;
  Bm += l * b_lane;
  C += l * c_lane;

  double* As = smem;                   // STAGES x OPA
  double* Bs = smem + STAGES * OPA;    // STAGES x OPB

  auto load = [&](int stage, int kt) {
    const int k0 = kt * BK;
    load_tile<AK, BM>(As + stage * OPA, A, a_row, a_col, i0, M, k0, K, a_vec,
                      tid);
    load_tile<BKC, BN>(Bs + stage * OPB, Bm, b_col, b_row, j0, N, k0, K,
                       b_vec, tid);
  };

  double acc[MT][NTL][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NTL; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load(s, kt0 + s);
    commit();
  }
  for (int it = 0; it < ntiles; ++it) {
    wait_groups<STAGES - 2>();
    __syncthreads();   // stage it ready; stage it - 1 free for everyone
    if (it + STAGES - 1 < ntiles)
      load((it + STAGES - 1) % STAGES, kt0 + it + STAGES - 1);
    commit();
    const double* as = As + (it % STAGES) * OPA;
    const double* bs = Bs + (it % STAGES) * OPB;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      double af[MT][4], bf[NTL][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int x = wm + mi * 16 + g;
        const double2 lo = frag2<AK, BM>(as, x, kk + 2 * t);
        const double2 hi = frag2<AK, BM>(as, x + 8, kk + 2 * t);
        af[mi][0] = lo.x;
        af[mi][1] = hi.x;
        af[mi][2] = lo.y;
        af[mi][3] = hi.y;
      }
#pragma unroll
      for (int ni = 0; ni < NTL; ++ni) {
        const double2 v = frag2<BKC, BN>(bs, wn + ni * 8 + g, kk + 2 * t);
        bf[ni][0] = v.x;
        bf[ni][1] = v.y;
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NTL; ++ni) mma16x8x8(acc[mi][ni], af[mi], bf[ni]);
    }
  }
  wait_groups<0>();

  const bool lower = flags & C_LOWER;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gi = i0 + wm + mi * 16 + g + 8 * h;
      if (gi >= M) continue;
      double* crow = C + (long long)gi * c_row;
#pragma unroll
      for (int ni = 0; ni < NTL; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gj = j0 + wn + ni * 8 + 2 * t + e;
          if (gj >= N || (lower && gj > gi)) continue;
          const double v = acc[mi][ni][2 * h + e];
          crow[gj] = beta == 0.0 ? alpha * v : alpha * v + beta * crow[gj];
        }
      }
    }
  }
}

template <bool AK, bool BKC>
int launch(dim3 grid, size_t smem, cudaStream_t stream, int M, int N, int K,
           double alpha, const double* A, long long a_lane, long long a_row,
           long long a_col, bool a_vec, const double* B, long long b_lane,
           long long b_row, long long b_col, bool b_vec, double beta,
           double* C, long long c_lane, long long c_row, int flags) {
  cudaError_t err = cudaFuncSetAttribute(
      dgemm_kernel<AK, BKC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dgemm_kernel<AK, BKC><<<grid, NT, smem, stream>>>(
      M, N, K, alpha, A, a_lane, a_row, a_col, a_vec, B, b_lane, b_row, b_col,
      b_vec, beta, C, c_lane, c_row, flags);
  return (int)cudaGetLastError();
}

// 16-byte copies along the contiguous axis: the base and the other two
// strides keep every pair of elements 16-byte aligned
bool aligned16(const double* p, long long s_lane, long long s_other) {
  return ((size_t)p % 16 == 0) && s_lane % 2 == 0 && s_other % 2 == 0;
}

}  // namespace

// C (lanes, M, N) = alpha * A (lanes, M, K) @ B (lanes, K, N) + beta * C,
// every operand addressed through its (lane, row, column) strides in
// elements (column stride 1 for C; lane stride 0 for a shared operand).
// flags: 1 write only C's elements with j <= i (tiles above the diagonal
// are not computed); 2 / 4 A lower / upper triangular (square), 8 / 16 B
// lower / upper triangular: its structural zeros are skipped.  Launches
// on `stream`; returns the CUDA error code of the launch.
extern "C" int eicos_dgemm(int lanes, int M, int N, int K, double alpha,
                           const double* A, long long a_lane, long long a_row,
                           long long a_col, const double* B, long long b_lane,
                           long long b_row, long long b_col, double beta,
                           double* C, long long c_lane, long long c_row,
                           int flags, void* stream) {
  if (lanes <= 0 || M <= 0 || N <= 0) return 0;
  if (lanes > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, lanes);
  const size_t smem = STAGES * (OPA + OPB) * sizeof(double);
  cudaStream_t st = (cudaStream_t)stream;
  // the contiguous axis of each operand: K (A's columns, B's rows) or not
  const bool ak = a_col == 1 || (a_row != 1 && a_col <= a_row);
  const bool bk = b_row == 1 || (b_col != 1 && b_row <= b_col);
  const bool a_vec = (ak ? a_col == 1 : a_row == 1) &&
                     aligned16(A, a_lane, ak ? a_row : a_col);
  const bool b_vec = (bk ? b_row == 1 : b_col == 1) &&
                     aligned16(B, b_lane, bk ? b_col : b_row);
  if (ak && bk)
    return launch<true, true>(grid, smem, st, M, N, K, alpha, A, a_lane, a_row,
                              a_col, a_vec, B, b_lane, b_row, b_col, b_vec,
                              beta, C, c_lane, c_row, flags);
  if (ak)
    return launch<true, false>(grid, smem, st, M, N, K, alpha, A, a_lane,
                               a_row, a_col, a_vec, B, b_lane, b_row, b_col,
                               b_vec, beta, C, c_lane, c_row, flags);
  if (bk)
    return launch<false, true>(grid, smem, st, M, N, K, alpha, A, a_lane,
                               a_row, a_col, a_vec, B, b_lane, b_row, b_col,
                               b_vec, beta, C, c_lane, c_row, flags);
  return launch<false, false>(grid, smem, st, M, N, K, alpha, A, a_lane, a_row,
                              a_col, a_vec, B, b_lane, b_row, b_col, b_vec,
                              beta, C, c_lane, c_row, flags);
}
