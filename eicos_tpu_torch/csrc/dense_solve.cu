// dense_fwd / dense_bwd: the two sweeps of a substitution solve against the
// dense LDL^T factor K = L diag(d) L^T, L unit lower triangular in 128-blocks,
// for a batch of lanes and up to 16 right-hand sides:
//
//   dense_fwd:  L y = b,  w = y / d   y_k = Xinv_k (b_k - sum_{c<k} L[k,c] y_c)
//   dense_bwd:  L' z = w              z_j = Xinv_j' (w_j - sum_{r>j} L[r,j]' z_r)
//
// Xinv_k is the inverse of the unit-lower diagonal block L[k,k] (the leaf
// inverse of the dense recursion).  The factor comes packed by dense_pack.cu:
// block [k, c], c < k, of lane l is the contiguous 128x128 row-major block at
// index k (k-1) / 2 + c, so row panel L[k, :k] is one contiguous stretch.
//
// Replace the Pallas kernels _make_dense_fwd and _make_dense_bwd of
// eicos_tpu/ops/pallas_dense_ds.py (via _dense_solve_batch and
// dense_solve_ds).  Those stream bf16 chunk stacks of a (hi, lo) f32 split of
// L in two orientations and carry the right-hand side as a double-single pair
// in VMEM across a sequential grid; these compute in native f64 from one copy
// of L, a loop over block rows inside the CTA taking the place of the grid.
// Right-hand sides keep the port's (k, Dp) layout per lane: column c of lane
// l is rhs[(l * k + c) * Dp + row].
//
// Bound: HBM bytes.  Each sweep reads every block of L once (128 KB) and the
// lower triangle of every Xinv for 2 k flops per element: at k = 2 that is
// half a flop per byte against the card's 20 (67 TFLOP/s over 3.35 TB/s).
//
// Design: one CTA of 256 threads per (lane, group of KT columns).  The group's
// right-hand side lives whole in shared memory, KT (Dp + 256) doubles, so KT
// is the largest of 16, 8, 4, 2, 1 that fits 227 KB (at Dp = 2048: 8 columns,
// at Dp = 7040: 4) and a wider solve runs several groups side by side, each
// reading L once.  The TPU's forward sweep is right-looking; here
//   * dense_fwd is left-looking: at block row k, a warp owns 16 rows of the
//     panel L[k, :k], its 32 threads read 128-wide stretches of a row
//     (coalesced, two rows in flight), multiply with the y blocks already in
//     shared memory and join their partial sums by warp shuffles; then the same
//     pattern applies Xinv_k (its lower triangle only).  The panels are read
//     in the order they lie in memory, first byte to last.
//   * dense_bwd is right-looking: z_j = Xinv_j' w_j, then w_c -= L[j,c]' z_j
//     for every c < j.  That reads the same row panel j (the left-looking form
//     would gather a block column), panel by panel from the last to the first.
//     A thread owns one column of a block and walks its 128 rows, so a warp
//     reads 256 contiguous bytes a row; the two halves of the CTA take
//     alternate blocks of the panel, and no sum is split between threads.
// Every sum runs in a fixed order: no atomics, the same bits on every run.
// One CTA per lane is serial over the nb block rows and fills as many SMs as
// there are lanes; several CTAs a lane, cp.async/TMA pipelines and DMMA are
// later work.

#include <cuda_runtime.h>

namespace {

constexpr int B = 128;
constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr int MAX_SMEM = 232448;   // dynamic shared memory a CTA can take

constexpr size_t smem_bytes(int kt, int Dp) {
  return (size_t)kt * (Dp + 2 * B) * sizeof(double);
}

template <int KT>
__device__ __forceinline__ void warp_sum(double (&acc)[KT]) {
#pragma unroll
  for (int c = 0; c < KT; ++c)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], o);
}

template <int KT>
__global__ void __launch_bounds__(NT, 1)
dense_fwd_kernel(const double* __restrict__ Lp, const double* __restrict__ Xinv,
                 const double* __restrict__ d, const double* __restrict__ rhs,
                 double* __restrict__ out, int Dp, int k) {
  extern __shared__ double sm[];
  double* ys = sm;                 // KT x Dp: the y blocks so far
  double* ts = ys + KT * Dp;       // KT x B: b_k - sum_c L[k,c] y_c

  const int tid = threadIdx.x;
  const int ln = tid & 31, warp = tid >> 5;
  const long long lane = blockIdx.x;
  const int c0 = blockIdx.y * KT;
  const int kc = min(KT, k - c0);  // live columns of this group
  const int nb = Dp / B;
  const double* Ll = Lp + lane * (long long)(nb * (nb - 1) / 2) * (B * B);
  const double* Xl = Xinv + lane * (long long)nb * (B * B);
  const double* dl = d + lane * Dp;
  const double* bl = rhs + (lane * k + c0) * (long long)Dp;
  double* ol = out + (lane * k + c0) * (long long)Dp;

  for (int kb = 0; kb < nb; ++kb) {
    const double* panel = Ll + (long long)(kb * (kb - 1) / 2) * (B * B);
    // t = b_kb - L[kb, :kb] y, two rows of a warp at a time
    for (int s = 0; s < B / NW; s += 2) {
      const int ia = warp + NW * s, ib = ia + NW;
      double acc_a[KT], acc_b[KT];
#pragma unroll
      for (int c = 0; c < KT; ++c) acc_a[c] = acc_b[c] = 0.0;
#pragma unroll 2
      for (int cb = 0; cb < kb; ++cb) {
        const double* blk = panel + (long long)cb * (B * B);
        const double* yb = ys + cb * B;
#pragma unroll
        for (int q = 0; q < B / 32; ++q) {
          const int j = ln + 32 * q;
          const double a = blk[ia * B + j], b = blk[ib * B + j];
#pragma unroll
          for (int c = 0; c < KT; ++c) {
            const double yv = yb[c * Dp + j];
            acc_a[c] = fma(a, yv, acc_a[c]);
            acc_b[c] = fma(b, yv, acc_b[c]);
          }
        }
      }
      warp_sum<KT>(acc_a);
      warp_sum<KT>(acc_b);
#pragma unroll
      for (int c = 0; c < KT; ++c)
        if (ln == c) {
          const bool live = c < kc;
          ts[c * B + ia] =
              (live ? bl[(long long)c * Dp + kb * B + ia] : 0.0) - acc_a[c];
          ts[c * B + ib] =
              (live ? bl[(long long)c * Dp + kb * B + ib] : 0.0) - acc_b[c];
        }
    }
    __syncthreads();
    // y_kb = Xinv_kb t: row i of the unit-lower block reaches column i
    const double* Xk = Xl + (long long)kb * (B * B);
    for (int s = 0; s < B / NW; ++s) {
      const int i = warp + NW * s;
      double acc[KT];
#pragma unroll
      for (int c = 0; c < KT; ++c) acc[c] = 0.0;
      for (int q = 0; 32 * q <= i; ++q) {
        const int j = ln + 32 * q;
        const double a = j <= i ? Xk[i * B + j] : 0.0;
#pragma unroll
        for (int c = 0; c < KT; ++c) acc[c] = fma(a, ts[c * B + j], acc[c]);
      }
      warp_sum<KT>(acc);
#pragma unroll
      for (int c = 0; c < KT; ++c)
        if (ln == c) ys[c * Dp + kb * B + i] = acc[c];
    }
    __syncthreads();
    for (int e = tid; e < kc * B; e += NT) {
      const int c = e / B, i = kb * B + e % B;
      ol[(long long)c * Dp + i] = ys[c * Dp + i] / dl[i];
    }
  }
}

template <int KT>
__global__ void __launch_bounds__(NT, 1)
dense_bwd_kernel(const double* __restrict__ Lp, const double* __restrict__ Xinv,
                 const double* __restrict__ w, double* __restrict__ out, int Dp,
                 int k) {
  extern __shared__ double sm[];
  double* ws = sm;                 // KT x Dp: w less the z blocks found so far
  double* zj = ws + KT * Dp;       // KT x B: the block of z just found
  double* red = zj + KT * B;       // KT x B: the upper half's partial sums

  const int tid = threadIdx.x;
  const int jj = tid & (B - 1), h = tid >> 7;
  const long long lane = blockIdx.x;
  const int c0 = blockIdx.y * KT;
  const int kc = min(KT, k - c0);
  const int nb = Dp / B;
  const double* Ll = Lp + lane * (long long)(nb * (nb - 1) / 2) * (B * B);
  const double* Xl = Xinv + lane * (long long)nb * (B * B);
  const double* wl = w + (lane * k + c0) * (long long)Dp;
  double* ol = out + (lane * k + c0) * (long long)Dp;

  for (int e = tid; e < KT * Dp; e += NT)
    ws[e] = e / Dp < kc ? wl[e] : 0.0;
  __syncthreads();

  for (int j = nb - 1; j >= 0; --j) {
    // z_j = Xinv_j' w_j: column jj of the unit-lower block starts at row jj;
    // the two halves of the CTA take alternate rows
    const double* Xj = Xl + (long long)j * (B * B);
    double acc[KT];
#pragma unroll
    for (int c = 0; c < KT; ++c) acc[c] = 0.0;
#pragma unroll 4
    for (int i = h; i < B; i += 2) {
      const double a = i >= jj ? Xj[i * B + jj] : 0.0;
#pragma unroll
      for (int c = 0; c < KT; ++c)
        acc[c] = fma(a, ws[c * Dp + j * B + i], acc[c]);
    }
    if (h == 1) {
#pragma unroll
      for (int c = 0; c < KT; ++c) red[c * B + jj] = acc[c];
    }
    __syncthreads();
    if (h == 0) {
#pragma unroll
      for (int c = 0; c < KT; ++c) {
        const double z = acc[c] + red[c * B + jj];
        zj[c * B + jj] = z;
        if (c < kc) ol[(long long)c * Dp + j * B + jj] = z;
      }
    }
    __syncthreads();
    // w_c -= L[j,c]' z_j for c < j, the halves on alternate blocks
    const double* panel = Ll + (long long)(j * (j - 1) / 2) * (B * B);
    for (int cb = h; cb < j; cb += 2) {
      const double* blk = panel + (long long)cb * (B * B);
#pragma unroll
      for (int c = 0; c < KT; ++c) acc[c] = 0.0;
#pragma unroll 8
      for (int i = 0; i < B; ++i) {
        const double a = blk[i * B + jj];
#pragma unroll
        for (int c = 0; c < KT; ++c) acc[c] = fma(a, zj[c * B + i], acc[c]);
      }
#pragma unroll
      for (int c = 0; c < KT; ++c) ws[c * Dp + cb * B + jj] -= acc[c];
    }
    __syncthreads();
  }
}

// the widest column group, of 16, 8, 4, 2, 1, that k needs and that fits
// shared memory at Dp; 0 if not even one column fits
int pick_kt(int k, int Dp) {
  int kt = 1;
  while (kt < k && kt < 16) kt *= 2;
  while (kt > 1 && smem_bytes(kt, Dp) > (size_t)MAX_SMEM) kt /= 2;
  return smem_bytes(kt, Dp) <= (size_t)MAX_SMEM ? kt : 0;
}

template <int KT>
int launch_fwd(const double* Lp, const double* Xinv, const double* d,
               const double* rhs, double* out, int lanes, int Dp, int k,
               cudaStream_t s) {
  const size_t bytes = smem_bytes(KT, Dp);
  cudaError_t err = cudaFuncSetAttribute(
      dense_fwd_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(lanes, (k + KT - 1) / KT);
  dense_fwd_kernel<KT><<<grid, NT, bytes, s>>>(Lp, Xinv, d, rhs, out, Dp, k);
  return (int)cudaGetLastError();
}

template <int KT>
int launch_bwd(const double* Lp, const double* Xinv, const double* w,
               double* out, int lanes, int Dp, int k, cudaStream_t s) {
  const size_t bytes = smem_bytes(KT, Dp);
  cudaError_t err = cudaFuncSetAttribute(
      dense_bwd_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(lanes, (k + KT - 1) / KT);
  dense_bwd_kernel<KT><<<grid, NT, bytes, s>>>(Lp, Xinv, w, out, Dp, k);
  return (int)cudaGetLastError();
}

}  // namespace

// Lp: (lanes, nb (nb-1) / 2, 128, 128) packed blocks of L (dense_pack.cu);
// Xinv: (lanes, nb, 128, 128) leaf inverses; d: (lanes, Dp); rhs, out:
// (lanes, k, Dp) with 1 <= k <= 16 and Dp = nb * 128.  Launches on `stream`;
// returns the CUDA error code of the launch (cudaErrorInvalidValue if one
// column of Dp doubles does not fit shared memory).
extern "C" int eicos_dense_fwd(const double* Lp, const double* Xinv,
                               const double* d, const double* rhs, double* out,
                               int lanes, int Dp, int k, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (pick_kt(k, Dp)) {
    case 16: return launch_fwd<16>(Lp, Xinv, d, rhs, out, lanes, Dp, k, s);
    case 8: return launch_fwd<8>(Lp, Xinv, d, rhs, out, lanes, Dp, k, s);
    case 4: return launch_fwd<4>(Lp, Xinv, d, rhs, out, lanes, Dp, k, s);
    case 2: return launch_fwd<2>(Lp, Xinv, d, rhs, out, lanes, Dp, k, s);
    case 1: return launch_fwd<1>(Lp, Xinv, d, rhs, out, lanes, Dp, k, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Lp, Xinv as for eicos_dense_fwd; w, out: (lanes, k, Dp).
extern "C" int eicos_dense_bwd(const double* Lp, const double* Xinv,
                               const double* w, double* out, int lanes, int Dp,
                               int k, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (pick_kt(k, Dp)) {
    case 16: return launch_bwd<16>(Lp, Xinv, w, out, lanes, Dp, k, s);
    case 8: return launch_bwd<8>(Lp, Xinv, w, out, lanes, Dp, k, s);
    case 4: return launch_bwd<4>(Lp, Xinv, w, out, lanes, Dp, k, s);
    case 2: return launch_bwd<2>(Lp, Xinv, w, out, lanes, Dp, k, s);
    case 1: return launch_bwd<1>(Lp, Xinv, w, out, lanes, Dp, k, s);
  }
  return (int)cudaErrorInvalidValue;
}
