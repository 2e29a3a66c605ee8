// leaf.cuh: the unpivoted LDL^T of one 128x128 block and the inverse of its
// unit-lower factor, both in shared memory, for one CTA of 256 threads, in
// the block's own type T (double or float).  band_factor.cu and
// band_factor_bw.cu run it on every block row; leaf_ldl.cu (f64) and
// leaf_ldl_f32.cu (f32) on every leaf of the dense recursion.  One copy of
// the code, so that the f64 kernels give the same bits for the same block.
//
// The block lives in S (row stride SLD = 129, so column walks hit distinct
// banks).  Only its lower triangle is read.
//   eliminate():       S's strict lower triangle <- L, dvec <- d, with
//                      |d| clamped to >= 1e-150 in f64 and 1e-20 in f32
//                      (the reference's clamps, ops/ldl._unblocked_ldl)
//   unit_lower_inv():  S's strict upper triangle <- (L^{-1})^T

#pragma once

#include <cuda_runtime.h>

namespace leaf {

constexpr int B = 128;
constexpr int SLD = B + 1;
constexpr int NT = 256;

// the pivot clamp of T
template <typename T>
__device__ __forceinline__ constexpr T tiny() {
  if constexpr (sizeof(T) == 8) {
    return T(1e-150);
  } else {
    return T(1e-20f);
  }
}

// 128 steps of a rank-1 update of the trailing lower triangle, two block
// barriers each.  lvec: B values of shared scratch.
template <typename T>
__device__ __forceinline__ void eliminate(T* S, T* dvec, T* lvec, int tid) {
  constexpr T TINY = tiny<T>();
  for (int j = 0; j < B; ++j) {
    T dj = S[j * SLD + j];
    if (fabs(dj) < TINY) dj = dj < T(0) ? -TINY : TINY;
    for (int i = j + 1 + tid; i < B; i += NT) lvec[i] = S[i * SLD + j] / dj;
    if (tid == 0) dvec[j] = dj;
    __syncthreads();
    const int nr = B - 1 - j;
    for (int e = tid; e < nr * nr; e += NT) {
      const int i = j + 1 + e / nr, c = j + 1 + e % nr;
      if (c <= i) S[i * SLD + c] -= (dj * lvec[i]) * lvec[c];
    }
    for (int i = j + 1 + tid; i < B; i += NT) S[i * SLD + j] = lvec[i];
    __syncthreads();
  }
}

// X = L^{-1} column by column, stored as X^T in the strict upper triangle:
// X[i][c] = -(L[i][c] + sum_{c<t<i} L[i][t] X[t][c]).  Two threads per
// column joined by a warp shuffle; no block barrier.  The caller
// synchronises before reading the result.
template <typename T>
__device__ __forceinline__ void unit_lower_inv(T* S, int tid) {
  const int c = tid >> 1, h = tid & 1;
  for (int i = 1; i < B; ++i) {
    T part = T(0);
    if (i > c)
      for (int t = c + 1 + h; t < i; t += 2)
        part = fma(S[i * SLD + t], S[c * SLD + t], part);
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (i > c && h == 0) S[c * SLD + i] = -(S[i * SLD + c] + part);
    __syncwarp();
  }
}

}  // namespace leaf
