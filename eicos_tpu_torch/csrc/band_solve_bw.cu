// band_fwd_bw / band_bwd_bw: the two triangular sweeps of a block-banded
// LDL^T solve at block bandwidth bw = 1..6, for a batch of lanes and up to 16
// right-hand sides.
//
// Replace the Pallas kernels _make_fwd_bw / _make_bwd_bw (through
// band_solve_ds_bw) of eicos_tpu/ops/pallas_band_ds.py.  Those stream a
// double-single factor and carry bw y or z blocks (and, backward, bw^2 L
// blocks) in VMEM rings; these read the f64 factor of band_factor_bw.cu, with
// L[k, k-j] stored at L[k][j-1]:
//
//   band_fwd_bw: y_k = Dinv_k (x_k - sum_{j=1..bw} L[k,k-j] y_{k-j}),
//                w_k = y_k / d_k
//   band_bwd_bw: z_k = Dinv_k^T (w_k - sum_{j=1..bw} L[k+j,k]^T z_{k+j}),
//                k = nb-1 .. 0
//
// Right-hand sides keep the layout of eicos_tpu's band_solve_ds_bw, (k, Dp)
// per lane: row `col` of lane `l` is rhs[(l * k + col) * Dp + row].
//
// Bound: each sweep needs the factor once, per lane and block row bw blocks
// of L (128 KB each) and the lower triangle of the unit-lower Dinv (64.5 KB),
// for 2 x 128^2 x k operations per full block: at most 4 operations per byte
// at k = 16, so the sweeps are bound by HBM bytes.  What keeps a sweep from
// that bound is latency: only the 128 x k y (or z) blocks carry the
// dependency from one block row to the next, and one CTA a lane with one
// panel in flight leaves most of the card idle.
//
// Design:
// - The factor stream is prefetched.  Every L and Dinv block a lane reads is
//   known before the sweep starts, so each CTA walks its panels (2048
//   doubles each) through a STAGES-deep cp.async ring in shared memory,
//   across block and block-row boundaries: while it multiplies one panel,
//   the next STAGES - 1 are in flight, and the waits at the y exchange do
//   not stall the stream.
// - Each lane runs on a thread-block cluster of C = 2 CTAs (64 lanes fill
//   128 of the 132 SMs).  CTA `rank` owns rows [rank R, rank R + R), R = 64, of
//   every block-row product: forward it reads row slabs of L[b, b-j] and
//   Dinv_b, backward column slabs of L[b+j, b] and Dinv_b (the transposed
//   products), 16 bytes a thread.  The residual block (x_b - sum L y) and
//   the new y (or z) block are exchanged through distributed shared memory:
//   each CTA writes its rows into every CTA of the cluster, then one cluster
//   barrier.  Two barriers a block row; the one after the y block also
//   guarantees that every CTA has read y_{b-bw} before its ring slot is
//   overwritten.
// - Only the lower triangle of Dinv is read: panels wholly above the
//   diagonal are skipped (they hold exact zeros, band_factor_bw.cu).
// - A thread owns one row and every PW / NG-th term of each panel's
//   contraction; the NG partial sums of a row are joined in a fixed order,
//   so a repeated call gives the same bits.  The right-hand sides are
//   carried KT wide (2, 8 or 16: the k of the call rounded up), zero past k.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cgr = cooperative_groups;

namespace {

constexpr int B = 128;
constexpr int KP = 16;   // most right-hand sides per call
constexpr int NT = 256;
constexpr int STAGES = 4;
constexpr int PANEL = 2048;   // doubles of the factor a panel carries
constexpr int BW_MAX = 6;
constexpr int C = 2;                // CTAs a lane (a cluster)
constexpr int R = B / C;            // rows a CTA owns
constexpr int PW = PANEL / R;       // contraction terms a panel
constexpr int PPB = B / PW;         // panels a full block
constexpr int NG = NT / R;          // threads a row
constexpr int RLD = PW + 2;         // forward panel row stride
constexpr int PSZ = R * RLD;        // doubles a ring stage

__device__ __forceinline__ void cp16(double* dst, const double* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
}

// FWD: row slabs (rows r0.., PW terms, stored [row][term]); else column
// slabs (PW terms, columns r0.., stored [term][row]).
template <int KT, bool FWD>
__global__ void __launch_bounds__(NT, 1)
sweep_kernel(const double* __restrict__ L, const double* __restrict__ Dinv,
             const double* __restrict__ d, const double* __restrict__ rhs,
             double* __restrict__ out, int nb, int bw, int k) {
  extern __shared__ double smem[];
  double* ring = smem;                          // STAGES x PSZ
  double* yring = ring + STAGES * PSZ;       // bw x (B x KT)
  double* acc = yring + bw * B * KT;            // B x KT
  double* red = acc + B * KT;                   // NG x R x KT

  cgr::cluster_group cl = cgr::this_cluster();
  const int rank = (int)cl.block_rank();
  const int r0 = rank * R;
  const int tid = threadIdx.x;
  const int i = tid % R, grp = tid / R;
  const int Dp = nb * B;
  const size_t blk = (size_t)B * B;
  const size_t lane = blockIdx.x / C;
  const double* L_l = L + lane * nb * bw * blk;
  const double* D_l = Dinv + lane * nb * blk;
  const double* x_l = rhs + lane * k * Dp;
  double* o_l = out + lane * k * Dp;

  // panels of block row b: its L blocks, then the lower part of Dinv_b
  const int dinv0 = FWD ? 0 : r0 / PW;
  const int ndinv = FWD ? (r0 + R + PW - 1) / PW : PPB - dinv0;
  auto jmax = [&](int b) {
    const int m = FWD ? b : nb - 1 - b;
    return m < bw ? m : bw;
  };

  // ---- producer: the panel stream, in the consumer's order
  int pb = FWD ? 0 : nb - 1, pq = 0;
  auto issue = [&](int slot) {
    if (pb < 0 || pb >= nb) return;
    const int nl = jmax(pb) * PPB;
    const double* src;
    int p;
    if (pq < nl) {
      const int j = pq / PPB + 1;
      p = pq % PPB;
      src = FWD ? L_l + ((size_t)pb * bw + j - 1) * blk
                : L_l + ((size_t)(pb + j) * bw + j - 1) * blk;
    } else {
      p = dinv0 + pq - nl;
      src = D_l + (size_t)pb * blk;
    }
    double* dst = ring + slot * PSZ;
#pragma unroll
    for (int q = 0; q < PANEL / 2 / NT; ++q) {
      const int c = tid + NT * q;
      if (FWD) {
        const int r = c / (PW / 2), t = (c % (PW / 2)) * 2;
        cp16(dst + r * RLD + t, src + (size_t)(r0 + r) * B + p * PW + t);
      } else {
        const int t = c / (R / 2), r = (c % (R / 2)) * 2;
        cp16(dst + t * R + r, src + (size_t)(p * PW + t) * B + r0 + r);
      }
    }
    if (++pq == nl + ndinv) {
      pq = 0;
      pb += FWD ? 1 : -1;
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    issue(s);
    commit();
  }
  int used = 0;
  auto next = [&]() -> const double* {
    wait_ring();
    __syncthreads();   // the panel is in; the slot used last is free
    issue((used + STAGES - 1) % STAGES);
    commit();
    return ring + (used++ % STAGES) * PSZ;
  };

  // s += (panel p of the block) x (vec rows), this thread's terms
  auto panel_mv = [&](double (&s)[KT], const double* P, const double* vec,
                      int p) {
#pragma unroll
    for (int u = 0; u < PW / NG; ++u) {
      const int t = grp + u * NG;
      const double a = FWD ? P[i * RLD + t] : P[t * R + i];
      const double* v = vec + (p * PW + t) * KT;
#pragma unroll
      for (int col = 0; col < KT; ++col) s[col] = fma(a, v[col], s[col]);
    }
  };
  // join the NG partial sums of each owned row in a fixed order; f(row,
  // col, sum) gets every (row, col) with col < KT
  auto join = [&](const double (&s)[KT], auto f) {
#pragma unroll
    for (int col = 0; col < KT; ++col) red[(grp * R + i) * KT + col] = s[col];
    __syncthreads();
    for (int e = tid; e < R * KT; e += NT) {
      const int r = e / KT, col = e % KT;
      double sum = red[r * KT + col];
      for (int g = 1; g < NG; ++g) sum += red[(g * R + r) * KT + col];
      f(r, col, sum);
    }
  };
  // write v at row r0 + r, column col of `buf` in every CTA of the cluster
  auto share = [&](double* buf, int r, int col, double v) {
#pragma unroll
    for (int q = 0; q < C; ++q)
      cl.map_shared_rank(buf, q)[(r0 + r) * KT + col] = v;
  };

  cl.sync();   // every CTA of the cluster runs before any writes into it
  for (int step = 0; step < nb; ++step) {
    const int b = FWD ? step : nb - 1 - step;
    const int jm = jmax(b);
    double s[KT];
#pragma unroll
    for (int col = 0; col < KT; ++col) s[col] = 0.0;
    for (int j = 1; j <= jm; ++j) {
      const double* v = yring + ((FWD ? b - j : b + j) % bw) * B * KT;
      for (int p = 0; p < PPB; ++p) panel_mv(s, next(), v, p);
    }
    join(s, [&](int r, int col, double sum) {
      const double x = col < k ? x_l[(size_t)col * Dp + b * B + r0 + r] : 0.0;
      share(acc, r, col, x - sum);
    });
    cl.sync();   // the residual block is whole in every CTA

#pragma unroll
    for (int col = 0; col < KT; ++col) s[col] = 0.0;
    for (int p = dinv0; p < dinv0 + ndinv; ++p) panel_mv(s, next(), acc, p);
    double* y = yring + (b % bw) * B * KT;
    join(s, [&](int r, int col, double sum) {
      share(y, r, col, sum);
      if (col < k)
        o_l[(size_t)col * Dp + b * B + r0 + r] =
            FWD ? sum / d[lane * Dp + b * B + r0 + r] : sum;
    });
    cl.sync();   // y_b is whole everywhere; y_{b-bw}'s slot was read
  }
}

template <int KT, bool FWD>
int launch(const double* L, const double* Dinv, const double* d,
           const double* rhs, double* out, int lanes, int nb, int bw, int k,
           cudaStream_t stream) {
  auto kern = sweep_kernel<KT, FWD>;
  const size_t smem = (size_t)(STAGES * PSZ + (bw + 1) * B * KT +
                               NG * R * KT) * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(lanes * C);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, L, Dinv, d, rhs, out, nb, bw, k);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool FWD>
int dispatch(const double* L, const double* Dinv, const double* d,
             const double* rhs, double* out, int lanes, int nb, int bw, int k,
             void* stream) {
  if (bw < 1 || bw > BW_MAX || k < 1 || k > KP || lanes < 1 || nb < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 2) return launch<2, FWD>(L, Dinv, d, rhs, out, lanes, nb, bw, k, s);
  if (k <= 8) return launch<8, FWD>(L, Dinv, d, rhs, out, lanes, nb, bw, k, s);
  return launch<16, FWD>(L, Dinv, d, rhs, out, lanes, nb, bw, k, s);
}

}  // namespace

// L: (lanes, nb, bw, 128, 128) f64 with L[k][j-1] = L[k, k-j]; Dinv: (lanes,
// nb, 128, 128) f64, unit lower with exact zeros above the diagonal; d:
// (lanes, nb, 128) f64; rhs, out: (lanes, k, nb * 128) f64 with 1 <= k <= 16
// and 1 <= bw <= 6.  Returns the CUDA error code of the launch (0 on success,
// cudaErrorInvalidValue for an argument out of range).
extern "C" int eicos_band_fwd_bw(const double* L, const double* Dinv,
                                 const double* d, const double* rhs,
                                 double* out, int lanes, int nb, int bw, int k,
                                 void* stream) {
  return dispatch<true>(L, Dinv, d, rhs, out, lanes, nb, bw, k, stream);
}

// L, Dinv as for eicos_band_fwd_bw; w, out: (lanes, k, nb * 128) f64.
extern "C" int eicos_band_bwd_bw(const double* L, const double* Dinv,
                                 const double* w, double* out, int lanes,
                                 int nb, int bw, int k, void* stream) {
  return dispatch<false>(L, Dinv, nullptr, w, out, lanes, nb, bw, k, stream);
}
