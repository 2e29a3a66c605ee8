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
// Bound: per block, ~B^3/3 flops of the elimination and ~B^3/6 FMAs of the
// inverse (~1 MFLOP) against the lower triangle of M read and Linv and d
// written (~197 KB): ~5 FLOP per byte, so bytes bound it at the card's
// balance (67 TFLOP/s over 3.35 TB/s is 20): 0.0076 ms for 128 blocks.
// What bounds it in practice is latency: a block's elimination is a chain
// of dependent steps on one SM.
//
// Design: one CTA of 256 threads per block.  The block is staged into
// shared memory (row stride 136) and factored and inverted there by the
// blocked leaf of leaf.cuh (panels of 16 columns, a warp-local diagonal
// factor, one thread a row for the substitution below it, the trailing
// update and the block inverse on DMMA: ~3 block barriers a panel and one
// a block row of the inverse, against the rank-1 loop's 256), the device
// code the band factor runs, so the two give the same bits for the same
// block.  M, Linv and d are addressed through lane and row strides, so the
// recursion reads a diagonal block of K and writes a diagonal block of
// Linv in place (M is read whole before Linv is written).

#include <cuda_runtime.h>

#include "leaf.cuh"

namespace {

using leaf::B;
using leaf::NT;

__global__ void __launch_bounds__(NT, 1)
leaf_ldl_kernel(const double* M, long long m_lane, long long m_row,
                double* Linv, long long x_lane, long long x_row,
                double* __restrict__ d, long long d_lane) {
  constexpr int LD = leaf::ld<double>();
  extern __shared__ __align__(16) double smem[];
  double* S = smem;               // B x LD
  double* W = S + B * LD;         // B x WLD
  double* dvec = W + B * leaf::WLD;  // 2 B

  const int tid = threadIdx.x;
  leaf::stage_lower(S, M + blockIdx.x * m_lane, m_row, tid);
  __syncthreads();
  leaf::eliminate(S, W, dvec, tid);
  leaf::unit_lower_inv(S, W, tid);
  leaf::store_inverse(S, Linv + blockIdx.x * x_lane, x_row, tid);
  for (int j = tid; j < B; j += NT) d[blockIdx.x * d_lane + j] = dvec[j];
}

constexpr size_t SMEM_BYTES = leaf::smem_elems<double>() * sizeof(double);

}  // namespace

// M: lanes blocks of 128x128 f64, element (l, i, j) at M[l*m_lane + i*m_row
// + j] (only j <= i is read); Linv: element (l, i, j) at Linv[l*x_lane +
// i*x_row + j], written whole (exact zeros above the diagonal); d: element
// (l, j) at d[l*d_lane + j].  Linv may be M itself.  Launches on `stream`;
// returns the CUDA error code of the launch (0 on success).
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
