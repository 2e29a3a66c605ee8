// leaf_ldl: LDL^T of a batch of 128x128 f64 blocks and the inverse of each
// unit-lower factor: M = L diag(d) L^T  ->  Linv = L^{-1}, d.
//
// Replaces the Pallas leaf kernels of eicos_tpu/ops/pallas_leaf_ds.py:
// _leaf_kernel_ds_blocked (one block per grid step, via leaf_ldl_pallas_ds)
// and the lane-tiled _make_leaf_tiled (via _leaf_ds_batch, the path of
// leaf_ldl_ds_one under the solver's lane vmap).  Those compute in
// double-single from a (hi, lo) f32 pair; this kernel computes in native
// IEEE f64.  L itself is not emitted: no caller uses it.  The dense
// recursion (ops/ldl.py) calls it once per 128-block leaf, with all lanes
// in one launch.
//
// Bound: per block, ~B^3/3 flops of rank-1 updates and ~B^3/6 FMAs of the
// inverse (~1 MFLOP) against 256 KB of HBM traffic (read M, write Linv):
// ~4 FLOP per byte, so bytes bound it at the card's balance (67 TFLOP/s over
// 3.35 TB/s is 20).  What bounds this design instead is latency: the
// elimination is 128 dependent steps with two block barriers each, and the
// inverse walks 127 dependent rows.
//
// Design: one CTA of 256 threads per block.  The block is staged into
// shared memory (row stride 129) and eliminated and inverted there by the
// same device code as the band factor's leaf (leaf.cuh), so the two kernels
// give the same bits for the same block.  M, Linv and d are addressed
// through lane and row strides, so the recursion reads a diagonal block of
// K and writes a diagonal block of Linv in place.  At fewer lanes than the
// card's 132 SMs the card is underfilled; several blocks per CTA or a
// blocked leaf are later work.

#include <cuda_runtime.h>

#include "leaf.cuh"

namespace {

using leaf::B;
using leaf::NT;
using leaf::SLD;

__global__ void __launch_bounds__(NT, 1)
leaf_ldl_kernel(const double* __restrict__ M, long long m_lane,
                long long m_row, double* __restrict__ Linv, long long x_lane,
                long long x_row, double* __restrict__ d, long long d_lane) {
  extern __shared__ double smem[];
  double* S = smem;           // B x SLD
  double* dvec = S + B * SLD;
  double* lvec = dvec + B;

  const int tid = threadIdx.x;
  const double* Ml = M + blockIdx.x * m_lane;
  for (int e = tid; e < B * B; e += NT) {
    const int i = e / B, j = e % B;
    if (j <= i) S[i * SLD + j] = Ml[i * m_row + j];
  }
  __syncthreads();
  leaf::eliminate(S, dvec, lvec, tid);
  leaf::unit_lower_inv(S, tid);
  __syncthreads();
  double* X = Linv + blockIdx.x * x_lane;
  for (int e = tid; e < B * B; e += NT) {
    const int i = e / B, c = e % B;
    X[i * x_row + c] = i > c ? S[c * SLD + i] : (i == c ? 1.0 : 0.0);
  }
  for (int j = tid; j < B; j += NT) d[blockIdx.x * d_lane + j] = dvec[j];
}

constexpr size_t SMEM_BYTES = (size_t)(B * SLD + 2 * B) * sizeof(double);

}  // namespace

// M: lanes blocks of 128x128 f64, element (l, i, j) at M[l*m_lane + i*m_row
// + j] (only j <= i is read); Linv: element (l, i, j) at Linv[l*x_lane +
// i*x_row + j], written whole (exact zeros above the diagonal); d: element
// (l, j) at d[l*d_lane + j].  Launches on `stream`; returns the CUDA error
// code of the launch (0 on success).
extern "C" int eicos_leaf_ldl(const double* M, long long m_lane,
                              long long m_row, double* Linv, long long x_lane,
                              long long x_row, double* d, long long d_lane,
                              int lanes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      leaf_ldl_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  leaf_ldl_kernel<<<lanes, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
      M, m_lane, m_row, Linv, x_lane, x_row, d, d_lane);
  return (int)cudaGetLastError();
}
