// dense_pack: gather the strictly-block-lower 128x128 blocks of a batch of
// row-major (Dp, Dp) f64 matrices into the layout the substitution sweeps
// stream (dense_solve.cu): block [k, c], c < k, of lane l becomes the
// contiguous 128 KB at out[(l * nblk + k (k-1) / 2 + c) * 128 * 128], nblk =
// nb (nb-1) / 2, so row panel L[k, :k] is one contiguous stretch and the
// panels follow each other.  Runs once per factor.
//
// Replaces the Pallas kernel _make_prechunk_kernel of
// eicos_tpu/ops/pallas_dense_ds.py (via _prechunk_cols_batch and
// prechunk_dense).  That kernel splits the same panels of L into bf16 chunk
// stacks with f32 scales, once per contraction orientation, because the TPU
// has no f64; here the values are moved as they are, once: the two sweeps
// read the same blocks.  The diagonal blocks and everything above them are
// never read.
//
// Bound: HBM bytes, 2 * 128 KB a block (read once, written once), no
// arithmetic.
//
// Design: one CTA of 256 threads per (block, lane).  A block's 128 rows of 1
// KB lie Dp * 8 bytes apart in the source; each thread moves 16 bytes at a
// time (double2), 64 threads a row, so a warp reads 512 contiguous bytes and
// writes 512 contiguous bytes.

#include <cuda_runtime.h>

namespace {

constexpr int B = 128;
constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
dense_pack_kernel(const double* __restrict__ src, double* __restrict__ out,
                  int Dp, int nblk) {
  // blockIdx.x = k (k-1) / 2 + c, c < k: invert by a short search from the
  // float estimate of k
  const int idx = blockIdx.x;
  int k = (int)((1.0f + sqrtf(1.0f + 8.0f * (float)idx)) * 0.5f);
  while (k * (k - 1) / 2 > idx) --k;
  while ((k + 1) * k / 2 <= idx) ++k;
  const int c = idx - k * (k - 1) / 2;
  const long long lane = blockIdx.y;
  const double2* s = reinterpret_cast<const double2*>(
      src + (lane * Dp + (long long)k * B) * Dp + (long long)c * B);
  double2* o = reinterpret_cast<double2*>(
      out + (lane * nblk + idx) * (long long)(B * B));
  const int row_stride = Dp / 2;          // in double2
  for (int e = threadIdx.x; e < B * (B / 2); e += NT) {
    const int i = e / (B / 2), j = e % (B / 2);
    o[e] = s[(long long)i * row_stride + j];
  }
}

}  // namespace

// src: (lanes, Dp, Dp) f64 row-major, Dp a multiple of 128 and >= 256, 16-byte
// aligned; out: (lanes, nb (nb-1) / 2, 128, 128).  Launches on `stream`;
// returns the CUDA error code of the launch (0 on success).
extern "C" int eicos_dense_pack(const double* src, double* out, int lanes,
                                int Dp, void* stream) {
  const int nb = Dp / B;
  const int nblk = nb * (nb - 1) / 2;
  dim3 grid(nblk, lanes);
  dense_pack_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(src, out, Dp, nblk);
  return (int)cudaGetLastError();
}
