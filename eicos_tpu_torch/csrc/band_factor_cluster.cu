// band_factor_cluster: the block-tridiagonal (block bandwidth 1) LDL^T of
// band_factor_bw.cu, one lane on a thread-block cluster of C = 2, 4 or 8
// CTAs, for batches whose lanes leave most SMs idle.
//
// Replaces no Pallas kernel beyond the ones band_factor_bw.cu replaces at
// bw = 1 (K1-K3: _band_factor_kernel, _make_band_factor_tiled,
// _make_band_factor_tiled_pre of eicos_tpu/ops/pallas_band_ds.py); it is
// the same function at the same bits, on another grid.
//
// Bound: the bytes (Kd, Ks in; L, Dinv, d out), as band_factor_bw.cu at
// bw 1.  What keeps one CTA a lane from it at few lanes is latency: a
// lane's block rows are a strict chain (L_k needs Dinv_{k-1}, the Schur
// update L_k, the leaf the Schur update), and one CTA walks it alone, so
// at 16 lanes 116 of the 132 SMs idle through every call while each CTA
// streams its loads and runs its products on one SM's tensor cores (on an
// H100 a block row took 86 us, 49 of them in the leaf).  On a cluster the
// leaf is what bounds it: 41 of a block row's 55 us at 16 lanes, C = 4.
//
// Design: the cluster's CTAs share each block row; the leaf, the serial
// floor, runs in every one of them.
// - Rank r of C owns the row blocks r 8/C .. (r + 1) 8/C - 1 of
//   L_k = (Ks_k Dinv_{k-1}^T) / d_{k-1} (C warps a row block, warp w the
//   column tiles w % C + C i, so that the clipped tiles spread), and every
//   (8 C)-th of the 72 lower 16x8 tiles of the Schur update
//   M = Kd_k - (L_k d_{k-1}) L_k^T.  It reads only its own rows of Ks_k
//   and its own tiles of Kd_k, and writes only its own rows of L_k.
// - Each CTA writes its tiles of M into the S of every CTA of the cluster
//   (distributed shared memory); after a cluster barrier every CTA runs the
//   leaf (leaf.cuh: eliminate, unit_lower_inv) on its own whole copy, in
//   the leaf's lookahead schedule (warp 0 factors the next panel's
//   diagonal block while the other warps update the trailing triangle).
//   The leaf's panels are 16-step pivot chains and row substitutions whose
//   time no number of SMs shortens, so repeating it costs nothing and
//   saves a barrier a panel; it leaves Dinv_k and d_k in every CTA's own
//   shared memory.  So L_{k+1} takes Dinv_k straight from S, and its left
//   operand, this rank's rows of Ks_{k+1}, was copied in (cp.async) while
//   the leaf ran, beside the leaf's scratch; Kd_{k+1}'s tiles were pulled
//   into L2 then too.  Each CTA stores its 1/C of Dinv_k, rank 0 d_k.
// - L_k, which every CTA's Schur update reads whole, is read back through
//   L2 (cp.async.cg) after a cluster barrier, whose release / acquire
//   orders the other CTAs' stores before the reads, through a ring of four
//   slabs (two in the one-CTA kernel).
// - Two cluster barriers a block row: L_k stored (and every CTA done with
//   its S), M in every CTA.
// - Same bits as band_factor_bw.cu at bw 1: every output tile keeps its
//   sequence of mma.sync m16n8k8 steps (the same 16 contraction steps of 8,
//   the same clipping, the same operand values, the scale -d of the left
//   operand applied in registers) and every scalar operation (1 / d is the
//   leaf's own reciprocal, which equals recip(d)); the leaf's schedule
//   moves no value.  So L, Dinv and d equal the one-CTA kernel's bit for
//   bit.
// - The kernel allocates nothing: the caller's L, Dinv and d are its only
//   outputs.  206 KB of shared memory a CTA at C = 4 and 8, 226 KB at 2.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "leaf.cuh"
#include "mma_f64.cuh"

namespace cgr = cooperative_groups;

namespace {

constexpr int B = leaf::B;
constexpr int LD = leaf::ld<double>();   // row stride of S
constexpr int NT = leaf::NT;
constexpr int NW = leaf::NW;
constexpr int BK = 16;                   // contraction depth of a stage
constexpr int NK = B / BK;               // stages a product
constexpr int OPND = B * BK;             // one slab: 128 rows of BK
constexpr int RSTAGES = 4;               // slabs in the Schur update's ring
constexpr int WSZ = B * leaf::WLD;       // the leaf's W (and the inverse's)
constexpr int NLOWER = 72;               // 16x8 tiles on or below the diagonal

// rows of Ks a rank holds, and the doubles after S: the ring, or W and
// those rows, whichever is larger (C = 2: 227 KB of shared memory in all)
template <int C>
constexpr int AROWS = B / C;
template <int C>
constexpr int RSZ = RSTAGES * OPND > WSZ + AROWS<C> * B
                        ? RSTAGES * OPND
                        : WSZ + AROWS<C> * B;
template <int C>
constexpr size_t SMEM_BYTES = (size_t)(B * LD + RSZ<C> + 2 * B) * sizeof(double);
static_assert(SMEM_BYTES<2> <= 232448, "227 KB of shared memory a CTA");

// the slab layout of band_factor_bw.cu: rows of BK, odd rows' pairs swapped
// by halves, so that a quarter warp's 16-byte fragment loads fall on
// distinct bank groups
static_assert(BK == 16, "slot() swizzles rows of 16");
__device__ __forceinline__ int slot(int x, int k) {
  return x * BK + (k ^ ((x & 1) << 3));
}

enum Form { GENERAL, LOWER };

// tiles a warp of rank r: the general product's 128 tiles over the C x 8
// warps of the cluster, the Schur update's 72 over the same, rounded up
template <int FORM, int C>
constexpr int NTILES = FORM == GENERAL ? 16 / C : (NLOWER + 8 * C - 1) / (8 * C);

// tile i of warp w of rank r: row block ra (16 rows), column tile cb (8
// columns); false for a slot past the last lower tile.
// GENERAL: rank r holds row blocks r 8/C .. (r + 1) 8/C - 1, C warps a row
//   block, warp w the column tiles w % C + C i.
// LOWER: the lower tiles in row order (row block a holds 2a + 2, a (a + 1)
//   before it), warp W = 8 r + w of the cluster every 8 C-th from W.
template <int FORM, int C>
__device__ __forceinline__ bool tile_of(int r, int w, int i, int& ra,
                                        int& cb) {
  if (FORM == GENERAL) {
    ra = r * (8 / C) + w / C;
    cb = w % C + C * i;
    return true;
  }
  const int x = NW * r + w + NW * C * i;
  if (x >= NLOWER) return false;
  int a = 0;
  while ((a + 1) * (a + 2) <= x) ++a;
  ra = a;
  cb = x - a * (a + 1);
  return true;
}

template <int FORM, int C>
using Acc = double[NTILES<FORM, C>][4];

// a warp's tiles, found once
template <int FORM, int C>
struct Tiles {
  int ra[NTILES<FORM, C>], cb[NTILES<FORM, C>];
  bool ok[NTILES<FORM, C>];
  __device__ __forceinline__ Tiles(int r, int warp) {
#pragma unroll
    for (int i = 0; i < NTILES<FORM, C>; ++i)
      ok[i] = tile_of<FORM, C>(r, warp, i, ra[i], cb[i]);
  }
};

// acc <- this warp's tiles of a row-major 128x128 block in global memory
template <int FORM, int C>
__device__ __forceinline__ void acc_load(Acc<FORM, C>& acc,
                                         const double* __restrict__ G,
                                         const Tiles<FORM, C>& tl, int tid) {
  const int g = (tid & 31) >> 2, t = tid & 3;
#pragma unroll
  for (int i = 0; i < NTILES<FORM, C>; ++i) {
    if (!tl.ok[i]) continue;
    const int ra = tl.ra[i], cb = tl.cb[i];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const double2 v = __ldg(reinterpret_cast<const double2*>(
          G + (16 * ra + g + 8 * h) * B + 8 * cb + 2 * t));
      acc[i][2 * h] = v.x;
      acc[i][2 * h + 1] = v.y;
    }
  }
}

// this warp's tiles into `dst` of every CTA in the cluster (dst is an
// address in this CTA's shared memory; the same offset in each), rank r
// starting at its own and going round, so that at each step the ranks
// write into different CTAs
template <int FORM, int C>
__device__ __forceinline__ void acc_to_cluster(cgr::cluster_group& cl,
                                               double* dst,
                                               const Acc<FORM, C>& acc,
                                               const Tiles<FORM, C>& tl,
                                               int r, int tid) {
  const int g = (tid & 31) >> 2, t = tid & 3;
#pragma unroll 1
  for (int q = 0; q < C; ++q) {
    double* S = cl.map_shared_rank(dst, (r + q) % C);
#pragma unroll
    for (int i = 0; i < NTILES<FORM, C>; ++i) {
      if (!tl.ok[i]) continue;
      const int ra = tl.ra[i], cb = tl.cb[i];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<double2*>(S + (16 * ra + g + 8 * h) * LD + 8 * cb +
                                    2 * t) =
            make_double2(acc[i][2 * h], acc[i][2 * h + 1]);
    }
  }
}

// S's lower Schur tiles: acc -= (L diag(d)) L^T over the 128-deep
// contraction, L (row-major 128x128 in global, this cluster's stores)
// streamed through a ring of RSTAGES slabs of 128 x BK, one slab serving
// both operands, the scale -d of the left operand applied to its fragments
// in registers, as product<LOWER> of band_factor_bw.cu (there a 2-stage
// ring; the steps and their operands are the same).
template <int C>
__device__ __forceinline__ void schur(Acc<LOWER, C>& acc, const double* Lg,
                                      const double* d, double* R,
                                      const Tiles<LOWER, C>& tl, int tid) {
  const int g = (tid & 31) >> 2, t = tid & 3;
  auto load = [&](int stage, int kc) {
    double* st = R + stage * OPND;
#pragma unroll
    for (int c = tid; c < B * BK / 2; c += NT) {
      const int x = c / (BK / 2), k = (c % (BK / 2)) * 2;
      mma::cp16(st + slot(x, k), Lg + (long long)x * B + kc * BK + k, 16);
    }
  };
#pragma unroll
  for (int s = 0; s < RSTAGES - 1; ++s) {
    load(s, s);
    mma::commit();
  }
#pragma unroll 1
  for (int kc = 0; kc < NK; ++kc) {
    mma::wait_groups<RSTAGES - 2>();
    __syncthreads();   // stage kc is in; stage kc - 1 is free for all
    if (kc + RSTAGES - 1 < NK)
      load((kc + RSTAGES - 1) % RSTAGES, kc + RSTAGES - 1);
    mma::commit();
    const double* bs = R + (kc % RSTAGES) * OPND;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      const int k8 = (kc * BK + kk) / 8;    // this 8-deep step of the 128
      const double2 dv =
          *reinterpret_cast<const double2*>(d + 8 * k8 + 2 * t);
      const double sx = -dv.x, sy = -dv.y;
#pragma unroll
      for (int i = 0; i < NTILES<LOWER, C>; ++i) {
        if (!tl.ok[i]) continue;
        const int x = 16 * tl.ra[i] + g;
        double2 lo = *reinterpret_cast<const double2*>(bs + slot(x, kk + 2 * t));
        double2 hi =
            *reinterpret_cast<const double2*>(bs + slot(x + 8, kk + 2 * t));
        lo.x *= sx;
        lo.y *= sy;
        hi.x *= sx;
        hi.y *= sy;
        const double a4[4] = {lo.x, hi.x, lo.y, hi.y};
        const double2 v = *reinterpret_cast<const double2*>(
            bs + slot(8 * tl.cb[i] + g, kk + 2 * t));
        const double bf[2] = {v.x, v.y};
        mma::mma16x8x8(acc[i], a4, bf);
      }
    }
  }
  mma::wait_groups<0>();
}

// element (x, k) of this rank's rows of Ks (x counted from its first row),
// k even: rows of B, odd rows' pairs swapped by halves, as slot()
__device__ __forceinline__ int aslot(int x, int k) {
  return x * B + (k ^ ((x & 1) << 3));
}

// acc += Ks_k Dinv_{k-1}^T on this warp's tiles, both operands in shared
// memory: A, this rank's rows of Ks_k (aslot, rows from 16 ra0); B, the
// unit-lower Dinv_{k-1} = X as unit_lower_inv left it in S (X[n][c] at
// S[c][n] below the diagonal, 1 on it, 0 above), the 8-deep step k8
// skipping column tiles cb < k8, as product<GENERAL, true> of
// band_factor_bw.cu.
template <int C>
__device__ __forceinline__ void lproduct(Acc<GENERAL, C>& acc,
                                         const double* A, const double* S,
                                         const Tiles<GENERAL, C>& tl, int ra0,
                                         int tid) {
  const int g = (tid & 31) >> 2, t = tid & 3;
  auto x_at = [&](int n, int c) {
    return n > c ? S[c * LD + n] : (n == c ? 1.0 : 0.0);
  };
#pragma unroll 2
  for (int k8 = 0; k8 < B / 8; ++k8) {
    const int k = 8 * k8 + 2 * t;
#pragma unroll
    for (int i = 0; i < NTILES<GENERAL, C>; ++i) {
      if (tl.cb[i] < k8) continue;
      const int x = 16 * (tl.ra[i] - ra0) + g;
      const double2 lo = *reinterpret_cast<const double2*>(A + aslot(x, k));
      const double2 hi =
          *reinterpret_cast<const double2*>(A + aslot(x + 8, k));
      const double a4[4] = {lo.x, hi.x, lo.y, hi.y};
      const int n = 8 * tl.cb[i] + g;
      const double bf[2] = {x_at(n, k), x_at(n, k + 1)};
      mma::mma16x8x8(acc[i], a4, bf);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(NT, 1)
band_factor_cluster_kernel(const double* __restrict__ Kd,
                           const double* __restrict__ Ks, double* Lout,
                           double* Dinv, double* dout, int nb) {
  extern __shared__ __align__(16) double smem[];
  double* S = smem;               // B x LD: M, then the leaf's L and X
  double* R = S + B * LD;         // the Schur update's ring; the leaf's W
  double* A = R + WSZ;            // this rank's rows of Ks_{k+1}
  double* dcur = R + RSZ<C>;      // d_k, then 1 / d_k

  cgr::cluster_group cl = cgr::this_cluster();
  const int r = (int)cl.block_rank();
  const int tid = threadIdx.x;
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const Tiles<GENERAL, C> gen(r, warp);
  const Tiles<LOWER, C> low(r, warp);
  const int ra0 = r * (8 / C);    // this rank's first row block
  const size_t blk = (size_t)B * B;
  const size_t lane = blockIdx.x / C;
  const double* Kd_l = Kd + lane * nb * blk;
  const double* Ks_l = Ks + lane * nb * blk;
  double* L_l = Lout + lane * nb * blk;
  double* Dinv_l = Dinv + lane * nb * blk;
  double* d_l = dout + lane * nb * B;
  constexpr int SHARE = B * B / C;   // elements of a block a rank stores

  // Dinv_k (this rank's share, in store_inverse's element order) and d_k
  // (rank 0) from S and dcur
  auto store_inverse = [&](int k) {
    double* out = Dinv_l + (size_t)k * blk;
    for (int e = r * SHARE + tid; e < (r + 1) * SHARE; e += NT) {
      const int q = e >> 5, ln = e & 31;
      const int i = (q & 15) * 8 + (ln & 7);
      const int c = (q >> 4) * 4 + (ln >> 3);
      out[i * B + c] = i > c ? S[c * LD + i] : (i == c ? 1.0 : 0.0);
    }
    if (r == 0)
      for (int j = tid; j < B; j += NT) d_l[(size_t)k * B + j] = dcur[j];
  };

  cl.sync();   // every CTA of the cluster runs before any writes into it
#pragma unroll 1
  for (int k = 0; k < nb; ++k) {
    double* Lk = L_l + (size_t)k * blk;
    if (k == 0) {
      for (int e = r * SHARE + tid; e < (r + 1) * SHARE; e += NT) Lk[e] = 0.0;
    } else {
      mma::wait_groups<0>();
      __syncthreads();   // Ks_k's rows are in A
      store_inverse(k - 1);
      Acc<GENERAL, C> acc;
#pragma unroll
      for (int i = 0; i < NTILES<GENERAL, C>; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.0;
      lproduct<C>(acc, A, S, gen, ra0, tid);
      // L_k = (Ks_k Dinv_{k-1}^T) / d_{k-1}, the quotients from 1 / d
#pragma unroll
      for (int i = 0; i < NTILES<GENERAL, C>; ++i) {
        const int ra = gen.ra[i], c = 8 * gen.cb[i] + 2 * t;
        const double2 dv = *reinterpret_cast<const double2*>(dcur + c);
        const double2 rv = *reinterpret_cast<const double2*>(dcur + B + c);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<double2*>(Lk + (16 * ra + g + 8 * h) * B + c) =
              make_double2(leaf::quot(acc[i][2 * h], dv.x, rv.x),
                           leaf::quot(acc[i][2 * h + 1], dv.y, rv.y));
      }
    }
    cl.sync();   // L_k is stored; every CTA is done with its S

    // the Schur update of the diagonal block (lower tiles) into every S
    {
      Acc<LOWER, C> acc;
      acc_load<LOWER, C>(acc, Kd_l + (size_t)k * blk, low, tid);
      if (k >= 1) schur<C>(acc, Lk, dcur, R, low, tid);
      acc_to_cluster<LOWER, C>(cl, S, acc, low, r, tid);
    }
    cl.sync();   // M is whole in every CTA

    // the next row's inputs load while the leaf runs: this rank's rows of
    // Ks_{k+1} into A, its tiles of Kd_{k+1} into L2
    if (k + 1 < nb) {
      const double* src = Ks_l + (size_t)(k + 1) * blk + (size_t)16 * ra0 * B;
#pragma unroll
      for (int c = tid; c < AROWS<C> * B / 2; c += NT) {
        const int x = c / (B / 2), kk = (c % (B / 2)) * 2;
        mma::cp16(A + aslot(x, kk), src + x * B + kk, 16);
      }
      mma::commit();
      if (t == 0) {
        const double* next = Kd_l + (size_t)(k + 1) * blk;
#pragma unroll
        for (int i = 0; i < NTILES<LOWER, C>; ++i)
          if (low.ok[i])
#pragma unroll
            for (int h = 0; h < 2; ++h)
              asm volatile("prefetch.global.L2 [%0];" ::"l"(
                  next + (16 * low.ra[i] + g + 8 * h) * B + 8 * low.cb[i]));
      }
    }
    leaf::eliminate<double, true>(S, R, dcur, tid);
    leaf::unit_lower_inv<double, true>(S, R, tid);
  }
  store_inverse(nb - 1);
}

template <int C>
cudaLaunchConfig_t config(int lanes, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(lanes * C);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = SMEM_BYTES<C>;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int C>
int launch(const double* Kd, const double* Ks, double* L, double* Dinv,
           double* d, int lanes, int nb, cudaStream_t stream) {
  auto kern = band_factor_cluster_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES<C>);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<C>(lanes, stream, attr);
  err = cudaLaunchKernelEx(&cfg, kern, Kd, Ks, L, Dinv, d, nb);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int C>
int active(int* out) {
  auto kern = band_factor_cluster_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES<C>);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<C>(1, 0, attr);
  return (int)cudaOccupancyMaxActiveClusters(out, kern, &cfg);
}

}  // namespace

// Kd, Ks: (lanes, nb, 128, 128) f64, Ks[:, k] = K[k, k-1] (Ks[:, 0] is not
// read); L: (lanes, nb, 128, 128) f64 out, L[:, 0] = 0; Dinv: (lanes, nb,
// 128, 128) f64 out; d: (lanes, nb, 128) f64 out; c = 2, 4 or 8 CTAs a lane.
// Every array 16-byte aligned.  Launches on `stream`; returns the CUDA
// error code of the launch (0 on success, cudaErrorInvalidValue for
// another c).
extern "C" int eicos_band_factor_cluster(const double* Kd, const double* Ks,
                                         double* L, double* Dinv, double* d,
                                         int lanes, int nb, int c,
                                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (c) {
    case 2: return launch<2>(Kd, Ks, L, Dinv, d, lanes, nb, s);
    case 4: return launch<4>(Kd, Ks, L, Dinv, d, lanes, nb, s);
    case 8: return launch<8>(Kd, Ks, L, Dinv, d, lanes, nb, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// *out <- how many clusters of c CTAs of this kernel the current device
// holds at once (cudaOccupancyMaxActiveClusters); returns the CUDA error
// code.
extern "C" int eicos_band_factor_clusters(int c, int* out) {
  switch (c) {
    case 2: return active<2>(out);
    case 4: return active<4>(out);
    case 8: return active<8>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}
