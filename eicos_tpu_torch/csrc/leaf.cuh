// leaf.cuh: the unpivoted LDL^T of one 128x128 block and the inverse of its
// unit-lower factor, both in shared memory, for one CTA of 256 threads, in
// the block's own type T (double or float).  band_factor_bw.cu runs it on
// every block row; leaf_ldl.cu (f64) and leaf_ldl_f32.cu (f32) on every
// leaf of the dense recursion.  One copy of the code, so that the f64
// kernels give the same bits for the same block.
//
// The block lives in S (row stride ld<T>()).  Only its lower triangle is
// read.
//   eliminate():       S's strict lower triangle <- L, dvec <- d (and
//                      1 / d after it), with |d| clamped to >= 1e-150 in
//                      f64 and 1e-20 in f32 (the reference's clamps,
//                      ops/ldl._unblocked_ldl)
//   unit_lower_inv():  S's strict upper triangle <- (L^{-1})^T
// Both also use W (B x WLD of T) as scratch; S's strict upper triangle is
// scratch during eliminate().
//
// Blocked, in panels of P = 16 columns (the TPU kernel's own panel width,
// _leaf_eliminate_blocked_b in eicos_tpu/ops/pallas_band_ds.py):
//   1. one warp factors the 16x16 diagonal block in registers (a lane a
//      row): 16 rank-1 steps with the clamp, the multipliers passed by
//      shuffles, one reciprocal a pivot (each quotient corrected to the
//      one division gives);
//   2. each row below it is an independent 16-term substitution, one
//      thread a row: L21 = A21 L11^{-T} D^{-1}, and W = -L21 D;
//   3. the trailing lower triangle takes A22 += W L21^T, a depth-16
//      product over the 16x8 tiles on or below the diagonal, on DMMA
//      (mma.sync m16n8k8 f64) in f64 and on FMA register tiles in f32
//      (mma.sync has no f32 operand but TF32, which the port does not
//      use).
// Steps 1 and 2 repeat the rank-1 loop's arithmetic for the panel's own
// columns; step 3 sums the trailing updates in another order.  Three block barriers a panel, against the
// rank-1 loop's 256 for the block.  eliminate<T, true> is the same
// arithmetic in a lookahead schedule (band_factor_cluster.cu): warp 0
// updates the next panel's diagonal block first and factors it while the
// other warps finish step 3, two barriers a panel.
// The inverse by blocks: the eight 16x16 unit-lower diagonal blocks are
// inverted at once, one warp each (X_ii, by substitution), then block rows
// i = 1..7 in turn: X_ij = -X_ii sum_{j<=s<i} L_is X_sj, 16x8 tiles on
// DMMA (FMA in f32), one block barrier a block row; each X_ij gets one
// step of refinement against L_ii, so that the product with the explicit
// X_ii is as accurate as a substitution.
//
// Layout: the f64 row stride of 136 (8 mod 16 doubles) puts the 16-byte
// fragment loads of a quarter warp (rows g, g + 1, columns 2t, 2t + 1) on
// distinct bank groups; f32 keeps the odd stride 129 of its column walks.

#pragma once

#include <cuda_runtime.h>

#include "mma_f64.cuh"

namespace leaf {

constexpr int B = 128;
constexpr int NT = 256;
constexpr int NW = NT / 32;     // warps
constexpr int P = 16;           // panel width
constexpr int NP = B / P;       // panels
constexpr int WLD = P + 8;      // row stride of W (and of the inverse's
                                // per-warp 8 x 16 scratch)

// row stride of S
template <typename T>
__host__ __device__ constexpr int ld() {
  return sizeof(T) == 8 ? B + 8 : B + 1;
}

// shared memory of a leaf kernel, in elements of T: S, W, dvec (2 B)
template <typename T>
__host__ __device__ constexpr int smem_elems() {
  return B * ld<T>() + B * WLD + 2 * B;
}

// the pivot clamp of T
template <typename T>
__device__ __forceinline__ constexpr T tiny() {
  if constexpr (sizeof(T) == 8) {
    return T(1e-150);
  } else {
    return T(1e-20f);
  }
}

template <typename T>
struct Pair {
  T x, y;
};

// (p[0], p[1]): one 16-byte load in f64 (p 16-byte aligned), two in f32
template <typename T>
__device__ __forceinline__ Pair<T> load2(const T* p) {
  if constexpr (sizeof(T) == 8) {
    const double2 v = *reinterpret_cast<const double2*>(p);
    return {v.x, v.y};
  } else {
    return {p[0], p[1]};
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, T x, T y) {
  if constexpr (sizeof(T) == 8) {
    *reinterpret_cast<double2*>(p) = make_double2(x, y);
  } else {
    p[0] = x;
    p[1] = y;
  }
}

// acc += A B over a depth-16 contraction for one 16x8 tile in the
// accumulator layout of mma_f64.cuh (thread (g, t) holds rows g, g + 8 and
// columns 2t, 2t + 1): a2(r, k) = (A[r][k], A[r][k+1]) for tile rows r,
// b2(n, k) = (B[k][n], B[k+1][n]) for tile columns n, k even.
template <typename T, class FA, class FB>
__device__ __forceinline__ void mac16(T (&acc)[4], FA a2, FB b2, int g,
                                      int t) {
  if constexpr (sizeof(T) == 8) {
    auto a = [&](int r, int k) {
      const Pair<T> v = a2(r, k);
      return make_double2(v.x, v.y);
    };
    auto b = [&](int n, int k) {
      const Pair<T> v = b2(n, k);
      return make_double2(v.x, v.y);
    };
    mma::mac8(acc, a, b, g, t, 0);
    mma::mac8(acc, a, b, g, t, 8);
  } else {
#pragma unroll
    for (int k = 0; k < P; k += 2) {
      const Pair<T> a0 = a2(g, k), a1 = a2(g + 8, k);
      const Pair<T> b0 = b2(2 * t, k), b1 = b2(2 * t + 1, k);
      acc[0] = fma(a0.y, b0.y, fma(a0.x, b0.x, acc[0]));
      acc[1] = fma(a0.y, b1.y, fma(a0.x, b1.x, acc[1]));
      acc[2] = fma(a1.y, b0.y, fma(a1.x, b0.x, acc[2]));
      acc[3] = fma(a1.y, b1.y, fma(a1.x, b1.x, acc[3]));
    }
  }
}

// 1 / x, rounded to nearest
template <typename T>
__device__ __forceinline__ T recip(T x) {
  if constexpr (sizeof(T) == 8) {
    return __drcp_rn(x);
  } else {
    return __frcp_rn(x);
  }
}

// a / d from r = recip(d): the product and one correction step, which
// gives the correctly rounded quotient of IEEE division (Markstein's
// theorem; the plain version divides) off the reciprocal that the pivot's
// row shares
template <typename T>
__device__ __forceinline__ T quot(T a, T d, T r) {
  const T q = a * r;
  return fma(r, fma(-d, q, a), q);
}

// S's lower triangle <- the lower triangle of a block in global memory,
// element (i, j) at M[i * row + j]; eight loads in flight a thread
template <typename T>
__device__ __forceinline__ void stage_lower(T* S, const T* M, long long row,
                                            int tid) {
  constexpr int LD = ld<T>(), U = 8;
  for (int e0 = 0; e0 < B * B; e0 += U * NT) {
    T v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * NT + tid, i = e / B, j = e % B;
      v[u] = j <= i ? M[i * row + j] : T(0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * NT + tid, i = e / B, j = e % B;
      if (j <= i) S[i * LD + j] = v[u];
    }
  }
}

// 1. the diagonal block of the panel at column c0 in registers, by one
// warp: lane r (and r + 16) holds row r.  With OWN, the lane that holds the
// next pivot updates it from its own multiplier before the shuffles that
// pass the multipliers, so the next pivot's shuffle does not wait for
// them; the value is the same (the shuffle to that lane returns its own).
template <typename T, bool OWN>
__device__ __forceinline__ void factor_diag(T* S, T* dvec, int c0, int lane) {
  constexpr int LD = ld<T>();
  constexpr T TINY = tiny<T>();
  T* rvec = dvec + B;
  const int r = lane & (P - 1);
  T a[P];
#pragma unroll
  for (int c = 0; c < P; ++c)
    a[c] = c <= r ? S[(c0 + r) * LD + c0 + c] : T(0);
  T next = a[0];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    T dj = __shfl_sync(0xffffffffu, OWN ? next : a[j], j);
    if (fabs(dj) < TINY) dj = dj < T(0) ? -TINY : TINY;
    const T rinv = recip(dj);
    const T l = r > j ? quot(a[j], dj, rinv) : T(0);
    const T w = dj * l;
    if (OWN && j + 1 < P) next = a[j + 1 < P ? j + 1 : j] - w * l;
#pragma unroll
    for (int c = j + 1; c < P; ++c) {
      const T lc = __shfl_sync(0xffffffffu, l, c);
      if (c <= r) a[c] -= w * lc;
    }
    if (r > j) a[j] = l;
    if (lane == j) {
      dvec[c0 + j] = dj;
      rvec[c0 + j] = rinv;
    }
  }
  if (lane < P)
#pragma unroll
    for (int c = 0; c < P; ++c)
      if (c < r) S[(c0 + r) * LD + c0 + c] = a[c];
}

// 3. trailing tile q of the panel at column c0: A22 += W L21^T on the lower
// 16x8 tiles, row block a (16 rows) holding tiles b = 0 .. 2a + 1, a (a + 1)
// tiles before it
template <typename T>
__device__ __forceinline__ void trailing_tile(T* S, const T* W, int c0, int q,
                                              int g, int t) {
  constexpr int LD = ld<T>();
  int a = 0;
  while ((a + 1) * (a + 2) <= q) ++a;
  const int r0 = c0 + P + 16 * a, n0 = c0 + P + 8 * (q - a * (a + 1));
  T acc[4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const Pair<T> v = load2(S + (r0 + g + 8 * h) * LD + n0 + 2 * t);
    acc[2 * h] = v.x;
    acc[2 * h + 1] = v.y;
  }
  mac16<T>(
      acc, [&](int r, int k) { return load2(W + (r0 + r) * WLD + k); },
      [&](int n, int k) { return load2(S + (n0 + n) * LD + c0 + k); }, g, t);
#pragma unroll
  for (int h = 0; h < 2; ++h)
    store2(S + (r0 + g + 8 * h) * LD + n0 + 2 * t, acc[2 * h], acc[2 * h + 1]);
}

// dvec: 2 B values of T, d and then 1 / d.  LOOKAHEAD (the same values,
// another schedule): warp 0 takes the two trailing tiles that hold the next
// panel's diagonal block and factors that block at once (OWN), while the
// other warps update the rest of the trailing triangle; one block barrier a
// panel fewer.
template <typename T, bool LOOKAHEAD = false>
__device__ __forceinline__ void eliminate(T* S, T* W, T* dvec, int tid) {
  constexpr int LD = ld<T>();
  T* rvec = dvec + B;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  if (LOOKAHEAD) {
    if (warp == 0) factor_diag<T, true>(S, dvec, 0, lane);
    __syncthreads();
  }
  for (int p = 0; p < NP; ++p) {
    const int c0 = p * P;
    if (!LOOKAHEAD) {
      if (warp == 0) factor_diag<T, false>(S, dvec, c0, lane);
      __syncthreads();
    }
    // 2. the rows below: l_ij = a_ij / d_j, a_ic -= (d_j l_ij) l_cj
    const int below = B - c0 - P;
    if (tid < below) {
      const int i = c0 + P + tid;
      T* Srow = S + i * LD + c0;
      T w[P];
#pragma unroll
      for (int j = 0; j < P; ++j) w[j] = Srow[j];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const T dj = dvec[c0 + j];
        const T l = quot(w[j], dj, rvec[c0 + j]);
        const T wj = dj * l;
#pragma unroll
        for (int c = j + 1; c < P; ++c)
          w[c] -= wj * S[(c0 + c) * LD + c0 + j];
        Srow[j] = l;
        W[i * WLD + j] = -wj;
      }
    }
    __syncthreads();
    // 3. the trailing lower triangle
    const int m = below / 16;
    if (LOOKAHEAD) {
      if (warp == 0) {
        if (m > 0) {
          trailing_tile(S, W, c0, 0, g, t);
          trailing_tile(S, W, c0, 1, g, t);
          factor_diag<T, true>(S, dvec, c0 + P, lane);
        }
      } else {
#pragma unroll 1
        for (int q = 1 + warp; q < m * (m + 1); q += NW - 1)
          trailing_tile(S, W, c0, q, g, t);
      }
    } else {
#pragma unroll 1
      for (int q = warp; q < m * (m + 1); q += NW)
        trailing_tile(S, W, c0, q, g, t);
    }
    __syncthreads();
  }
}

// X = L^{-1} by blocks, stored as X^T in S's strict upper triangle: X[r][c]
// at S[c][r].  Ends with a block barrier.
// UNROLL (the same values): the diagonal blocks' sums unrolled, their loads
// issued together.
template <typename T, bool UNROLL = false>
__device__ __forceinline__ void unit_lower_inv(T* S, T* W, int tid) {
  constexpr int LD = ld<T>();
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // the diagonal blocks, one warp each: lanes c and c + 16 split column c's
  // sum X[i][c] = -(L[i][c] + sum_{c<s<i} L[i][s] X[s][c])
  {
    const int c0 = warp * P, c = lane & (P - 1), h = lane >> 4;
#pragma unroll 1
    for (int i = 1; i < P; ++i) {
      T part = T(0);
      if (UNROLL) {
#pragma unroll
        for (int u = 0; u < P / 2; ++u) {
          const int s = c + 1 + h + 2 * u;
          if (s < i)
            part = fma(S[(c0 + i) * LD + c0 + s], S[(c0 + c) * LD + c0 + s],
                       part);
        }
      } else if (i > c)
        for (int s = c + 1 + h; s < i; s += 2)
          part = fma(S[(c0 + i) * LD + c0 + s], S[(c0 + c) * LD + c0 + s],
                     part);
      part += __shfl_xor_sync(0xffffffffu, part, 16);
      if (i > c && h == 0)
        S[(c0 + c) * LD + c0 + i] = -(S[(c0 + i) * LD + c0 + c] + part);
      __syncwarp();
    }
  }
  __syncthreads();
  // block row i: 2i tiles (block column j, column half nh), 16 x 8 each
  T* Tt = W + warp * 8 * WLD;   // this warp's -T^T (then R^T), 8 x 16
  T* Yt = Tt + NW * 8 * WLD;    // and its first Y^T
#pragma unroll 1
  for (int i = 1; i < NP; ++i) {
    const int ci = i * P;
#pragma unroll 1
    for (int q = warp; q < 2 * i; q += NW) {
      const int j = q >> 1, cj = j * P + 8 * (q & 1);
      T acc[4] = {T(0), T(0), T(0), T(0)};
      // T = sum_{j<=s<i} L_is X_sj; X_sj[k][n] sits at S[cj + n][cs + k]
#pragma unroll 1
      for (int s = j; s < i; ++s) {
        const int cs = s * P;
        auto lis = [&](int r, int k) {
          return load2(S + (ci + r) * LD + cs + k);
        };
        if (s > j) {
          mac16<T>(acc, lis,
                   [&](int n, int k) {
                     return load2(S + (cj + n) * LD + cs + k);
                   },
                   g, t);
        } else {   // X_jj: unit diagonal, zeros above it
          mac16<T>(acc, lis,
                   [&](int n, int k) {
                     const int col = cj + n;
                     auto x = [&](int row) {
                       return row > col ? S[col * LD + row]
                                        : (row == col ? T(1) : T(0));
                     };
                     return Pair<T>{x(cs + k), x(cs + k + 1)};
                   },
                   g, t);
        }
      }
      __syncwarp();   // the previous tile's reads of Tt are done
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          Tt[(2 * t + e) * WLD + g + 8 * h] = -acc[2 * h + e];
      __syncwarp();
      // X_ij solves L_ii X_ij = -T: Y = X_ii (-T), then one step of
      // refinement, Y += X_ii (-T - L_ii Y), which keeps the product with
      // the explicit inverse as accurate as a substitution
      auto xii = [&](int r, int k) {   // X_ii[r][k] sits at S[ci + k][ci + r]
        auto x = [&](int kk) {
          return r > kk ? S[(ci + kk) * LD + ci + r] : (r == kk ? T(1) : T(0));
        };
        return Pair<T>{x(k), x(k + 1)};
      };
      auto tt = [&](int n, int k) { return load2(Tt + n * WLD + k); };
      T out[4] = {T(0), T(0), T(0), T(0)};
      mac16<T>(out, xii, tt, g, t);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          Yt[(2 * t + e) * WLD + g + 8 * h] = out[2 * h + e];
      __syncwarp();
      T res[4] = {-acc[0], -acc[1], -acc[2], -acc[3]};
      mac16<T>(res,
               [&](int r, int k) {   // -L_ii, unit lower
                 auto x = [&](int kk) {
                   return r > kk ? -S[(ci + r) * LD + ci + kk]
                                 : (r == kk ? T(-1) : T(0));
                 };
                 return Pair<T>{x(k), x(k + 1)};
               },
               [&](int n, int k) { return load2(Yt + n * WLD + k); }, g, t);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          Tt[(2 * t + e) * WLD + g + 8 * h] = res[2 * h + e];
      __syncwarp();
      mac16<T>(out, xii, tt, g, t);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          S[(cj + 2 * t + e) * LD + ci + g + 8 * h] = out[2 * h + e];
    }
    __syncthreads();
  }
}

// Linv[i][c] = X[i][c] (exact 1 on the diagonal, 0 above) from S after
// unit_lower_inv, element (i, c) at out[i * row + c].  A warp writes 8 rows
// x 4 columns at a time: full 32-byte sectors of out, and f64 reads of S's
// columns on distinct bank groups.
template <typename T>
__device__ __forceinline__ void store_inverse(const T* S, T* out,
                                              long long row, int tid) {
  constexpr int LD = ld<T>();
  for (int e = tid; e < B * B; e += NT) {
    const int q = e >> 5, lane = e & 31;
    const int i = (q & 15) * 8 + (lane & 7);
    const int c = (q >> 4) * 4 + (lane >> 3);
    out[i * row + c] = i > c ? S[c * LD + i] : (i == c ? T(1) : T(0));
  }
}

}  // namespace leaf
