// mma_f64.cuh: the f64 tensor-core and cp.async helpers shared by dgemm.cu
// and the blocked leaf / band factor (leaf.cuh, band_factor_bw.cu).
//
// mma16x8x8 is one mma.sync m16n8k8 f64 (a DMMA instruction on sm_90).  In
// a warp, thread (g, t) = (lane / 4, lane % 4) holds
//   A (16 x 8): a[0] = A[g][s],  a[1] = A[g + 8][s],
//               a[2] = A[g][s'], a[3] = A[g + 8][s'],
//   B (8 x 8):  b[0] = B[s][g],  b[1] = B[s'][g],
//   C (16 x 8): c[2h + e] = C[g + 8h][2t + e],
// with k-slots s = t and s' = t + 4.  Every caller maps slot t to
// contraction index 2t and slot t + 4 to 2t + 1, in A and B alike (the
// k-slots are summed, so any one-to-one map the two operands share gives
// the product): a thread then reads (x, 2t) and (x, 2t + 1) of a
// K-contiguous operand as one 16-byte load (frag2).

#pragma once

#include <cuda_runtime.h>

namespace mma {

// 16 bytes global -> shared, asynchronous, through L2 only (.cg: a CTA's own
// earlier global writes are read back correctly); bytes < 16 zero-fills
__device__ __forceinline__ void cp16(double* dst, const double* src,
                                     int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp8(double* dst, const double* src,
                                    int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Elements (x, k) and (x, k + 1) of a tile in shared memory: one 16-byte
// load where K is the contiguous axis (KC: S[x * LDK + k]), else two loads
// (S[k * LDX + x]).
template <bool KC, int LDK, int LDX>
__device__ __forceinline__ double2 frag2(const double* S, int x, int k) {
  if (KC) return *reinterpret_cast<const double2*>(S + x * LDK + k);
  return make_double2(S[k * LDX + x], S[(k + 1) * LDX + x]);
}

__device__ __forceinline__ void mma16x8x8(double (&d)[4], const double (&a)[4],
                                          const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// acc += A B for one 16 x 8 tile over the eight contraction indices
// k0 .. k0 + 7, from pairs: a2(r, k) = (A[r][k], A[r][k + 1]) for the
// tile's rows r = g, g + 8; b2(n, k) = (B[k][n], B[k + 1][n]) for its
// column n = g.
template <class FA, class FB>
__device__ __forceinline__ void mac8(double (&acc)[4], FA a2, FB b2, int g,
                                     int t, int k0) {
  const double2 lo = a2(g, k0 + 2 * t), hi = a2(g + 8, k0 + 2 * t);
  const double2 bv = b2(g, k0 + 2 * t);
  const double af[4] = {lo.x, hi.x, lo.y, hi.y};
  const double bf[2] = {bv.x, bv.y};
  mma16x8x8(acc, af, bf);
}

}  // namespace mma
