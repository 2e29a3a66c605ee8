// spmv: the static-pattern product x @ M of the residuals, the LP-row
// elimination and computeResiduals, with the sites' concatenation and
// affine tail in the same pass, for every row of a lane-batched x:
//
//   acc[l, r, j] = sum_{t = colptr[j]}^{colptr[j+1]-1} vals[l, t] a[l, r, rows[t]]
//   out[l, r, j] = ((base[l, r, j] op acc) + w[l, r, j]) + gamma x[l, r, j]
//
// with op one of base + acc, base - acc, acc - base (no base: acc, -acc,
// acc), and each of base, w, x optional.  The contraction input is two
// segments [a0 | a1] (rows of M below km0 come from a0), so a site never
// concatenates its operands first.  The output's columns may split at one
// column into two epilogue segments, each with its own base, w and x, so
// one launch writes [ey | ez] of the stacked residual.  Every input is a
// strided (lanes, k, cols) view: a lane stride, a row stride, unit columns.
//
// M is given as a CSC array of its nonzeros (column pointers, rows,
// values), built from ops/spmv.csc_table's padded table without its pads;
// the values are shared (lane stride 0) or per lane.
//
// Counterpart of eicos_tpu/ops/spmv.py SparseOperand.rmatmul, which the
// JAX package runs as an XLA gather and width-grouped sum (no Pallas
// kernel) inside one jitted step, where XLA fuses the gather's consumers;
// on the TPU path it carries every narrow residual and elimination product
// in place of the dense GEMV kernel _gemv_call (ops/pallas_gemm_ds.py).
//
// Bound: HBM bytes.  Each product reads a (L k km doubles), the epilogue's
// inputs (L k nm doubles each) and the table once (4 + 8 bytes a nonzero,
// 8 more a lane for per-lane values) and writes out (L k nm doubles), for
// 2 flops a nonzero a row: far below the card's balance of 20 flops a byte.
//
// Design: a CTA takes a tile of NT consecutive output columns, one a
// thread, and a group of R rows of a (any R rows for shared values, R rows
// of one lane for per-lane values).  A thread reads its column's colptr,
// and each slot's row and value, once, and gathers and accumulates them
// against its R rows, so the table is read once a group, not once a row,
// and each slot's index load feeds R independent gathers.  The gathers go
// through L1 (a row of a is at most 96 KB on the paths).  R is two: at the
// paths' shapes (128 lanes, k = 1, 2, nm 498-12032) two rows a thread were
// the fastest or within 5 % of it, four or eight up to 1.5x slower where
// they leave too few CTAs (PERF.md, S1's times by R).  One thread sums
// each output element in the table's slot order, with no atomics, so the
// product gives the bits of a one-row-a-thread chain and a repeated call
// repeats.  The epilogue rounds op by op (__dadd_rn, __dsub_rn,
// __dmul_rn: no FMA contraction), so a fused site gives the bits of the
// product followed by the same torch ops in the same order.

#include <cuda_runtime.h>

struct EicosStrided {       // element (l, r, j) at p[l * ls + r * rs + j]
  const double* p;
  long long ls, rs;
};

// The arguments of one call (passed by value to the kernel), every field
// eight bytes, so a caller packs them as a flat array.  a1 is read for
// rows of M at or above km0 (km0 == km: a0 alone).  Columns below `split`
// take epilogue segment 0 (base[0], w[0], x[0]), the others segment 1
// indexed from `split`; a null pointer leaves its term out.  op: 0 base +
// acc, 1 base - acc, 2 acc - base.
struct EicosSpmvArgs {
  EicosStrided a0, a1;
  long long km0;
  const int* colptr;
  const int* rows;
  const double* vals;
  long long vstride;        // 0: shared values; nnz: per lane
  double* out;              // contiguous (lanes, k, nm)
  long long lanes, k, km, nm;
  long long op;
  double gamma;
  long long split;
  EicosStrided base[2], w[2], x[2];
};

namespace {

constexpr int NT = 128;
constexpr int R = 2;        // rows a thread

// by value: the kernel's argument stays in parameter space, not copied to
// local memory as taking its address would
__device__ __forceinline__ EicosStrided pick(int s, EicosStrided s0,
                                             EicosStrided s1) {
  return s ? s1 : s0;
}

__device__ __forceinline__ double at(EicosStrided v, long long lane,
                                     long long r, int j) {
  return __ldg(v.p + lane * v.ls + r * v.rs + j);
}

__global__ void __launch_bounds__(NT)
spmv_kernel(const EicosSpmvArgs g) {
  const int j = blockIdx.y * NT + threadIdx.x;
  const int nm = (int)g.nm, k = (int)g.k, km0 = (int)g.km0;
  if (j >= nm) return;
  // the group's rows: flat rows q0 .. q0 + nr of the (lanes * k) rows
  long long q0;
  int nr;
  if (g.vstride) {                       // per lane: R rows of one lane
    const int gpl = (k + R - 1) / R;
    const long long lane = blockIdx.x / gpl;
    const int r0 = (int)(blockIdx.x % gpl) * R;
    q0 = lane * k + r0;
    nr = min(R, k - r0);
  } else {
    q0 = (long long)blockIdx.x * R;
    nr = (int)min((long long)R, g.lanes * k - q0);
  }
  const double* vl = g.vals + (q0 / k) * g.vstride;
  const double* a0r[R];
  const double* a1r[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const long long q = q0 + (i < nr ? i : 0);
    const long long lane = q / k, r = q % k;
    a0r[i] = g.a0.p + lane * g.a0.ls + r * g.a0.rs;
    a1r[i] = g.a1.p + lane * g.a1.ls + r * g.a1.rs;
  }
  // the epilogue's inputs, loaded before the gathers so that their
  // latency hides behind the product's
  const int s = j >= g.split;
  const int jj = s ? j - (int)g.split : j;
  const EicosStrided base = pick(s, g.base[0], g.base[1]);
  const EicosStrided w = pick(s, g.w[0], g.w[1]);
  const EicosStrided x = pick(s, g.x[0], g.x[1]);
  double bv[R], wv[R], xv[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const long long q = q0 + (i < nr ? i : 0);
    const long long lane = q / k, r = q % k;
    bv[i] = base.p ? at(base, lane, r, jj) : 0.0;
    wv[i] = w.p ? at(w, lane, r, jj) : 0.0;
    xv[i] = x.p ? at(x, lane, r, jj) : 0.0;
  }
  double acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.0;
  const int t1 = __ldg(g.colptr + j + 1);
  for (int t = __ldg(g.colptr + j); t < t1; ++t) {
    const int src = __ldg(g.rows + t);
    const double v = __ldg(vl + t);
    const bool lo = src < km0;
    const int off = lo ? src : src - km0;
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (i < nr) acc[i] = fma(v, __ldg((lo ? a0r[i] : a1r[i]) + off), acc[i]);
  }
  // the epilogue, op by op in the order of the torch ops it replaces
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i >= nr) break;
    double y = acc[i];
    if (base.p) {
      y = g.op == 0 ? __dadd_rn(bv[i], y)
                    : (g.op == 1 ? __dsub_rn(bv[i], y) : __dsub_rn(y, bv[i]));
    } else if (g.op == 1) {
      y = -y;
    }
    if (w.p) y = __dadd_rn(y, wv[i]);
    if (x.p) y = __dadd_rn(y, __dmul_rn(g.gamma, xv[i]));
    g.out[(q0 + i) * nm + j] = y;
  }
}

}  // namespace

// One fused product (see EicosSpmvArgs).  Launches on `stream`; returns
// the CUDA error code of the launch.
extern "C" int eicos_spmv(const EicosSpmvArgs* args, void* stream) {
  EicosSpmvArgs g = *args;
  if (g.lanes * g.k == 0 || g.nm == 0) return 0;
  if (g.a1.p == nullptr) g.a1 = g.a0;
  const long long groups = g.vstride ? g.lanes * ((g.k + R - 1) / R)
                                     : (g.lanes * g.k + R - 1) / R;
  dim3 grid((unsigned)groups, (unsigned)((g.nm + NT - 1) / NT));
  spmv_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}
