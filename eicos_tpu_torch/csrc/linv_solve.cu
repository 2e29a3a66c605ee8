// linv_fwd / linv_bwd: the two products of a solve with an explicit-inverse
// LDL^T factor, K x = rhs  <=>  x = Linv^T ((Linv rhs) / d), for a batch of
// lanes and up to 16 right-hand sides.
//
//   linv_fwd: t[c, i] = (sum_{j <= i} Linv[i, j] rhs[c, j]) / d[i]
//   linv_bwd: x[c, j] =  sum_{i >= j} Linv[i, j] t[c, i]
//
// Replace the Pallas kernel _gemv_kernel_prechunked of
// eicos_tpu/ops/pallas_gemm_ds.py (via _gemv_pre_call and
// PrechunkedOperand.rmatmul, which ops/ldl.ldl_solve runs twice per solve,
// once on a transposed and once on a plain prechunk of Linv).  That kernel
// streams bf16 chunk stacks of a (hi, lo) f32 split of Linv made once per
// factor; these stream the f64 Linv of the dense recursion as it is, and
// need no prechunk.
//
// Right-hand sides keep the port's (k, Dp) layout per lane, as the band
// sweeps do: column c of lane l is rhs[(l * k + c) * Dp + row].
//
// Bound: HBM bytes.  Each pass reads Linv once for 2 k flops per element:
// at k = 16 that is 4 flops per byte, a fifth of the card's balance (67
// TFLOP/s over 3.35 TB/s is 20 flops per byte).  Linv's strict upper
// triangle is exact zeros (products of lower-triangular matrices stay lower
// triangular, in the kernels' factor and in the plain version's), so both
// passes skip it: they read Dp (Dp + 1) / 2 elements a lane, not Dp^2.
//
// Design: neither pass materialises a transpose (that would be another
// (L, Dp, Dp) copy per factor).
//   * linv_fwd reads row panels: a CTA owns 32 rows of one lane, 4 a warp;
//     the 32 threads of a warp read 128-wide stretches of a row, coalesced,
//     and the right-hand sides stream through shared memory in 128-wide
//     chunks (16 x 3328 f64 would not fit whole); each thread keeps partial
//     sums for its 4 rows and every column, joined by warp shuffles at the
//     end.
//   * linv_bwd reads column panels of the same row-major Linv: a CTA owns
//     64 columns of one lane; the 64 threads of a row group read 64
//     neighbouring elements of a row, coalesced; 4 row groups split each
//     64-row chunk of t, and their partial sums are joined through shared
//     memory at the end.
// The loads are not overlapped with the FMAs beyond what the warps in
// flight give; cp.async or TMA pipelines are later work.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;
constexpr int FW_ROWS = 32;     // rows per CTA in linv_fwd
constexpr int FW_CHUNK = 128;   // rhs chunk width
constexpr int BW_COLS = 64;     // columns per CTA in linv_bwd
constexpr int BW_CHUNK = 64;    // t chunk height
constexpr int BW_GROUPS = NT / BW_COLS;

template <int KT>
__global__ void __launch_bounds__(NT)
linv_fwd_kernel(const double* __restrict__ Linv, const double* __restrict__ d,
                const double* __restrict__ rhs, double* __restrict__ out,
                int Dp, int k) {
  __shared__ double rs[KT][FW_CHUNK];
  const int tid = threadIdx.x;
  const int lanew = tid & 31, warp = tid >> 5;
  const long long lane = blockIdx.y;
  constexpr int WR = FW_ROWS / (NT / 32);   // rows per warp
  const int r0 = blockIdx.x * FW_ROWS;
  const int row0 = r0 + warp * WR;
  const double* Ll = Linv + lane * Dp * (long long)Dp;
  const double* xl = rhs + lane * k * (long long)Dp;

  double acc[WR][KT];
#pragma unroll
  for (int r = 0; r < WR; ++r)
#pragma unroll
    for (int c = 0; c < KT; ++c) acc[r][c] = 0.0;

  for (int j0 = 0; j0 < r0 + FW_ROWS; j0 += FW_CHUNK) {
    __syncthreads();
    for (int e = tid; e < KT * FW_CHUNK; e += NT) {
      const int c = e / FW_CHUNK, jj = e % FW_CHUNK;
      rs[c][jj] = c < k ? xl[(long long)c * Dp + j0 + jj] : 0.0;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < WR; ++r) {
      const int i = row0 + r;
      const double* Lrow = Ll + (long long)i * Dp + j0;
#pragma unroll
      for (int q = 0; q < FW_CHUNK / 32; ++q) {
        const int jj = lanew + 32 * q;
        const double a = (j0 + jj <= i) ? Lrow[jj] : 0.0;
#pragma unroll
        for (int c = 0; c < KT; ++c) acc[r][c] = fma(a, rs[c][jj], acc[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < WR; ++r) {
    const int i = row0 + r;
    const double di = d[lane * Dp + i];
#pragma unroll
    for (int c = 0; c < KT; ++c) {
      double v = acc[r][c];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lanew == c && c < k) out[(lane * k + c) * (long long)Dp + i] = v / di;
    }
  }
}

template <int KT>
__global__ void __launch_bounds__(NT)
linv_bwd_kernel(const double* __restrict__ Linv, const double* __restrict__ t,
                double* __restrict__ out, int Dp, int k) {
  __shared__ double ts[KT][BW_CHUNK];
  __shared__ double red[BW_GROUPS][KT][BW_COLS];
  const int tid = threadIdx.x;
  const int jc = tid % BW_COLS, rg = tid / BW_COLS;
  const long long lane = blockIdx.y;
  const int j0 = blockIdx.x * BW_COLS;
  const int j = j0 + jc;
  const double* Ll = Linv + lane * Dp * (long long)Dp;
  const double* tl = t + lane * k * (long long)Dp;

  double acc[KT];
#pragma unroll
  for (int c = 0; c < KT; ++c) acc[c] = 0.0;

  for (int i0 = j0; i0 < Dp; i0 += BW_CHUNK) {
    __syncthreads();
    for (int e = tid; e < KT * BW_CHUNK; e += NT) {
      const int c = e / BW_CHUNK, ii = e % BW_CHUNK;
      ts[c][ii] = c < k ? tl[(long long)c * Dp + i0 + ii] : 0.0;
    }
    __syncthreads();
#pragma unroll 4
    for (int q = 0; q < BW_CHUNK / BW_GROUPS; ++q) {
      const int ii = rg + BW_GROUPS * q;
      const int i = i0 + ii;
      const double a = i >= j ? Ll[(long long)i * Dp + j] : 0.0;
#pragma unroll
      for (int c = 0; c < KT; ++c) acc[c] = fma(a, ts[c][ii], acc[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < KT; ++c) red[rg][c][jc] = acc[c];
  __syncthreads();
  for (int e = tid; e < k * BW_COLS; e += NT) {
    const int c = e / BW_COLS, col = e % BW_COLS;
    double v = 0.0;
#pragma unroll
    for (int g = 0; g < BW_GROUPS; ++g) v += red[g][c][col];
    out[(lane * k + c) * (long long)Dp + j0 + col] = v;
  }
}

// the smallest instantiated width that holds k columns
template <template <int> class Launch, typename... Args>
int dispatch(int k, Args... args) {
  if (k <= 2) return Launch<2>::run(args...);
  if (k <= 4) return Launch<4>::run(args...);
  if (k <= 8) return Launch<8>::run(args...);
  return Launch<16>::run(args...);
}

template <int KT>
struct FwdLaunch {
  static int run(const double* Linv, const double* d, const double* rhs,
                 double* out, int lanes, int Dp, int k, cudaStream_t s) {
    dim3 grid(Dp / FW_ROWS, lanes);
    linv_fwd_kernel<KT><<<grid, NT, 0, s>>>(Linv, d, rhs, out, Dp, k);
    return (int)cudaGetLastError();
  }
};

template <int KT>
struct BwdLaunch {
  static int run(const double* Linv, const double* t, double* out, int lanes,
                 int Dp, int k, cudaStream_t s) {
    dim3 grid(Dp / BW_COLS, lanes);
    linv_bwd_kernel<KT><<<grid, NT, 0, s>>>(Linv, t, out, Dp, k);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// Linv: (lanes, Dp, Dp) f64, row-major, lower triangular; d: (lanes, Dp);
// rhs, out: (lanes, k, Dp) with 1 <= k <= 16 and Dp a multiple of 128.
// Launches on `stream`; returns the CUDA error code of the launch.
extern "C" int eicos_linv_fwd(const double* Linv, const double* d,
                              const double* rhs, double* out, int lanes,
                              int Dp, int k, void* stream) {
  return dispatch<FwdLaunch>(k, Linv, d, rhs, out, lanes, Dp, k,
                             (cudaStream_t)stream);
}

// Linv as for eicos_linv_fwd; t, out: (lanes, k, Dp).
extern "C" int eicos_linv_bwd(const double* Linv, const double* t, double* out,
                              int lanes, int Dp, int k, void* stream) {
  return dispatch<BwdLaunch>(k, Linv, t, out, lanes, Dp, k,
                             (cudaStream_t)stream);
}
