// spmv: the static-pattern product x @ M of the residuals and the LP-row
// elimination, for every row of a lane-batched x:
//
//   out[l, r, j] = sum_{t = colptr[j]}^{colptr[j+1]-1} vals[l, t] a[l, r, rows[t]]
//
// M is given as a CSC array of its nonzeros (column pointers, rows,
// values), built from ops/spmv.csc_table's padded table without its pads;
// the values are shared (lane stride 0) or per lane.
//
// Counterpart of eicos_tpu/ops/spmv.py SparseOperand.rmatmul, which the
// JAX package runs as an XLA gather and width-grouped sum (no Pallas
// kernel): on the TPU path it carries every narrow residual and elimination
// product in place of the dense GEMV kernel _gemv_call
// (ops/pallas_gemm_ds.py).
//
// Bound: HBM bytes.  Each product reads a (L k km doubles) and the table
// (4 + 8 bytes a nonzero, 8 more a lane for per-lane values) and writes out
// (L k nm doubles), for 2 flops a nonzero a row: far below the card's
// balance of 20 flops a byte.
//
// Design: one CTA walks one row of a (a lane's right-hand side), and its
// threads take consecutive output columns, so colptr and out are read and
// written coalesced and neighbouring columns' nonzeros lie side by side.
// The gathers from the row go through L1 (a row is at most 96 KB on the
// paths; staging it in shared memory first measured no faster on the H100,
// PERF.md).  Where there are fewer rows than twice the SMs, the columns of
// a row are split over several CTAs.  One thread sums each output element,
// in the table's slot order, with no atomics: a repeated call gives the
// same bits.  Pad slots do not exist in the CSC form, so there is no width
// grouping: that is a workaround for XLA's padding.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
spmv_kernel(const double* __restrict__ a, const int* __restrict__ colptr,
            const int* __restrict__ rows, const double* __restrict__ vals,
            long long vstride, double* __restrict__ out, int k, int km,
            int nm) {
  const long long row = blockIdx.x;            // lane * k + r
  const long long lane = row / k;
  const double* ar = a + row * km;
  const double* vl = vals + lane * vstride;
  double* o = out + row * nm;
  for (int j = blockIdx.y * NT + threadIdx.x; j < nm; j += gridDim.y * NT) {
    const int t1 = colptr[j + 1];
    double acc = 0.0;
    for (int t = colptr[j]; t < t1; ++t)
      acc = fma(vl[t], __ldg(ar + rows[t]), acc);
    o[j] = acc;
  }
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 132;
}

}  // namespace

// a: (lanes, k, km) f64, contiguous; colptr: (nm + 1) int32; rows: (nnz)
// int32; vals: (nnz) f64 shared (vstride 0) or (lanes, nnz) with vstride
// nnz; out: (lanes, k, nm).  Launches on `stream`; returns the CUDA error
// code of the launch.
extern "C" int eicos_spmv(const double* a, const int* colptr, const int* rows,
                          const double* vals, long long vstride, double* out,
                          int lanes, int k, int km, int nm, void* stream) {
  const long long nrows = (long long)lanes * k;
  if (nrows == 0 || nm == 0) return 0;
  const int tiles = (nm + NT - 1) / NT;
  const int want = (int)((2LL * sm_count() + nrows - 1) / nrows);
  dim3 grid((unsigned)nrows, tiles < want ? tiles : want);
  spmv_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(a, colptr, rows, vals,
                                                     vstride, out, k, km, nm);
  return (int)cudaGetLastError();
}
