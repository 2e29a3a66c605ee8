// leaf_ldl_f32: LDL^T of a batch of 128x128 f32 blocks and the inverse of
// each unit-lower factor: M = L diag(d) L^T  ->  Linv = L^{-1}, d.  The f32
// leaf of the dense recursion under Settings.factor_dtype = "float32".
//
// Replaces the Pallas kernel _leaf_kernel_full of eicos_tpu/ops/pallas_leaf.py
// (via leaf_ldl_pallas and _pallas_call).  That kernel eliminates with masked
// reductions over a (128, 128) tile and inverts L by seven Newton-Schulz
// doublings on the TPU's matrix unit; this one runs the blocked leaf of the
// f64 kernel (leaf.cuh) on float: panels of 16 columns, the trailing
// updates and the block inverse on FMA register tiles (mma.sync takes f32
// only as TF32, which the port does not use).  Pivots are clamped at
// +-1e-20 as in the reference's XLA f32 leaf (its Pallas leaf does not
// clamp).
//
// Bound: per block ~B^3/3 flops of the elimination and ~B^3/6 FMAs of the
// inverse (~1 MFLOP) against 97 KB of HBM traffic (the lower triangle of M
// read, Linv and d written): ~11 FLOP per byte, so bytes bound it (the card's
// f32 balance is 67 TFLOP/s over 3.35 TB/s = 20): 0.0038 ms for 128 blocks.
// What bounds it in practice is latency, as for the f64 leaf: a chain of
// dependent steps on one SM, cut by the blocking to ~3 block barriers a
// panel.
//
// Design: one CTA of 256 threads per block, the block staged in shared
// memory at row stride 129 (77 KB with the panel scratch), M, Linv and d
// addressed through lane and row strides so the recursion reads a diagonal
// block of K and writes a diagonal block of Linv in place.

#include <cuda_runtime.h>

#include "leaf.cuh"

namespace {

using leaf::B;
using leaf::NT;

__global__ void __launch_bounds__(NT, 1)
leaf_ldl_f32_kernel(const float* M, long long m_lane, long long m_row,
                    float* Linv, long long x_lane, long long x_row,
                    float* __restrict__ d, long long d_lane) {
  constexpr int LD = leaf::ld<float>();
  extern __shared__ __align__(16) float smemf[];
  float* S = smemf;               // B x LD
  float* W = S + B * LD;          // B x WLD
  float* dvec = W + B * leaf::WLD;  // 2 B

  const int tid = threadIdx.x;
  leaf::stage_lower(S, M + blockIdx.x * m_lane, m_row, tid);
  __syncthreads();
  leaf::eliminate(S, W, dvec, tid);
  leaf::unit_lower_inv(S, W, tid);
  leaf::store_inverse(S, Linv + blockIdx.x * x_lane, x_row, tid);
  for (int j = tid; j < B; j += NT) d[blockIdx.x * d_lane + j] = dvec[j];
}

constexpr size_t SMEM_BYTES = leaf::smem_elems<float>() * sizeof(float);

}  // namespace

// M: lanes blocks of 128x128 f32, element (l, i, j) at M[l*m_lane + i*m_row
// + j] (only j <= i is read); Linv: element (l, i, j) at Linv[l*x_lane +
// i*x_row + j], written whole (exact zeros above the diagonal); d: element
// (l, j) at d[l*d_lane + j].  Linv may be M itself.  Launches on `stream`;
// returns the CUDA error code of the launch (0 on success).
extern "C" int eicos_leaf_ldl_f32(const float* M, long long m_lane,
                                  long long m_row, float* Linv,
                                  long long x_lane, long long x_row, float* d,
                                  long long d_lane, int lanes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      leaf_ldl_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  leaf_ldl_f32_kernel<<<lanes, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
      M, m_lane, m_row, Linv, x_lane, x_row, d, d_lane);
  return (int)cudaGetLastError();
}
