// cones: the second-order-cone work of an interior-point iteration, each
// call one launch in f64, in place of the plain path's chains of small
// elementwise, gather and batched-product kernels:
//
//   cone_scalings     cones.update_scalings (the NT scalings) and its
//                     lam = W z, the LP entries in the same launch
//   cone_eig          kkt._soc_eig (each cone's W^2 in its eigenbasis),
//                     _soc_kept_vals (-(diag(lam) + delta I)) and
//                     _soc_coupling_vals (rot G_soc)
//   cone_rotate       kkt._soc_rotate: rot x or rot' x, cone by cone
//   cone_line_search  cones.line_search for a structure with cones
//
// The JAX package computes these as XLA fusions inside its jitted step (no
// Pallas kernel), where XLA fuses the gathers and their consumers.
//
// Layout.  A cone vector is [LP (l) | SOC_0 | SOC_1 | ...] along its last
// axis, one lane a row: a lane stride and unit column stride.  offs (n_sc +
// 1, int32) holds each cone's first entry in the SOC segment, then ms.  The
// per-cone fields (a, w, eta, eta2, cc, dd) are (lanes, n_sc); q_flat is
// (lanes, ms) with 0 at the heads.  rot, the kept blocks and the coupling
// are padded per cone to D = the largest cone dimension: rot and kept
// (lanes, n_sc, D, D), lam (lanes, n_sc, D), the coupling (lanes, n_sc, D,
// w) on the cones' column supports.
//
// Arithmetic.  Every operation is rounded on its own (__dadd_rn, __dmul_rn,
// __ddiv_rn, __dsqrt_rn: no FMA contraction, IEEE division and square
// root), in the plain path's order, so that NaNs from the square roots of
// out-of-cone iterates flow on as there.  A sum over a cone's entries runs
// as ``segsum``'s fixed order: entry by entry from the head, then + 0.0 where
// the cone is shorter than the structure's longest (the plain sum adds its
// pad slots); with those, the scalings, lam, the line search and the eigen
// closed form give the plain path's bits up to segsum.SEQUENTIAL_MAX = 16
// slots.  Where the plain path's order belongs to a library (vector_norm and
// the sum of h*h in _soc_eig, the 4x4 products of _soc_rotate, rot @ G_soc,
// segsum's reduction past 16 slots), the sums here run entry by entry.
//
// Bound: HBM bytes.  A call reads each of its inputs once and writes its
// outputs once, a few operations a byte; cone_eig's outputs (D*D + D + D*D
// + D*w doubles a cone) are the largest, ~16 MB at 128 lanes of 302 cones
// of D = 4.  In cone_scalings and cone_line_search one thread walks one
// cone, so a cone of hundreds of entries is correct but serial there; in
// cone_eig and cone_rotate one thread takes one row of a cone (its D
// threads read and write neighbouring rows), each working out the cone's
// eigen closed form anew in cone_eig.
//
// Built without nvcc (a host C++ compiler, -ffp-contract=off), the file is
// plain C++ and its entry points run their threads' work one after another
// on the host: a CPU test drives them through ops/soc.py against the plain
// path.

#include <cmath>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define EICOS_HD __host__ __device__ __forceinline__
#else
#define EICOS_HD inline
#endif

namespace {

EICOS_HD double add(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dadd_rn(a, b);
#else
  return a + b;
#endif
}

EICOS_HD double sub(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dsub_rn(a, b);
#else
  return a - b;
#endif
}

EICOS_HD double mul(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dmul_rn(a, b);
#else
  return a * b;
#endif
}

EICOS_HD double dvd(double a, double b) {
#ifdef __CUDA_ARCH__
  return __ddiv_rn(a, b);
#else
  return a / b;
#endif
}

EICOS_HD double root(double a) {
#ifdef __CUDA_ARCH__
  return __dsqrt_rn(a);
#else
  return std::sqrt(a);
#endif
}

EICOS_HD bool isnan_(double a) { return a != a; }

// torch.minimum / torch.maximum / amin: a NaN operand gives NaN
EICOS_HD double nmin(double a, double b) {
  return isnan_(a) ? a : (isnan_(b) ? b : (b < a ? b : a));
}

EICOS_HD double nmax(double a, double b) {
  return isnan_(a) ? a : (isnan_(b) ? b : (a < b ? b : a));
}

// segsum's pad slots: x + 0.0 once where the cone has fewer entries than
// the structure's slots (it turns a -0.0 sum into +0.0, as the plain sum)
EICOS_HD double pad(double acc, int d, int slots) {
  return d < slots ? add(acc, 0.0) : acc;
}

// ------------------------------------------------------------- scalings

struct ConeScal {
  double a, w, eta, eta2, cc, dd;
};

// One cone of cones.update_scalings and then cones.scale (lam = W z): s,
// z, q and lam point at the cone's head entry, d entries each.
EICOS_HD ConeScal scalings_cone(const double* s, const double* z, int d,
                                int slots, double* q, double* lam) {
  const double s0 = s[0], z0 = z[0];
  double ss = mul(s0, s0), zz = mul(z0, z0);
  for (int j = 1; j < d; ++j) {
    ss = add(ss, mul(s[j], s[j]));
    zz = add(zz, mul(z[j], z[j]));
  }
  ss = pad(ss, d, slots);
  zz = pad(zz, d, slots);
  // NaN if out of cone: it propagates
  const double snorm = root(sub(mul(mul(2.0, s0), s0), ss));
  const double znorm = root(sub(mul(mul(2.0, z0), z0), zz));
  ConeScal c;
  c.eta2 = dvd(snorm, znorm);
  c.eta = root(c.eta2);
  // skbar = s / snorm, zkbar = z / znorm, entry by entry
  double g = mul(dvd(s0, snorm), dvd(z0, znorm));
  for (int j = 1; j < d; ++j)
    g = add(g, mul(dvd(s[j], snorm), dvd(z[j], znorm)));
  g = pad(g, d, slots);
  const double half_by_gamma = dvd(0.5, root(mul(0.5, add(1.0, g))));
  c.a = mul(half_by_gamma, add(dvd(s0, snorm), dvd(z0, znorm)));
  q[0] = 0.0;
  double w = mul(0.0, 0.0);
  for (int j = 1; j < d; ++j) {
    const double qj = mul(half_by_gamma, sub(dvd(s[j], snorm),
                                             dvd(z[j], znorm)));
    q[j] = qj;
    w = add(w, mul(qj, qj));
  }
  c.w = pad(w, d, slots);
  const double one_a = add(1.0, c.a);
  c.cc = add(one_a, dvd(c.w, one_a));
  c.dd = add(add(1.0, dvd(2.0, one_a)), dvd(c.w, mul(one_a, one_a)));
  // lam = W z
  double zeta = mul(q[0], z0);
  for (int j = 1; j < d; ++j) zeta = add(zeta, mul(q[j], z[j]));
  zeta = pad(zeta, d, slots);
  const double factor = add(z0, dvd(zeta, add(1.0, c.a)));
  lam[0] = mul(c.eta, add(mul(c.a, z0), zeta));
  for (int j = 1; j < d; ++j)
    lam[j] = mul(c.eta, add(z[j], mul(factor, q[j])));
  return c;
}

// ---------------------------------------------------------------- eigen

// One cone's W^2 in its eigenbasis, in kkt._soc_eig's closed form: with t
// the cone's q tail over the D - 1 tail slots, qh = t / |t| (e1 where |t|
// is not above 0), h = qh + sign(qh_1) e1 and H = I - (2 / h'h) h h', rot's
// rows are (1, qh) r and (1, -qh) r, r = sqrt(1/2), then (0, H[:, j]) for
// j = 1 .. D-2; a cone of dimension one is its head alone.  Pad rows and
// columns are multiplied by 0, as the plain path masks them.
struct ConeEig {
  const double* q;    // the cone's head entry of q_flat
  int d, D;
  double nq, sgn, inv, r;

  EICOS_HD double tq(int i) const { return 1 + i < d ? q[1 + i] : 0.0; }
  EICOS_HD double t(int i) const {
    return nq > 0.0 ? dvd(tq(i), nq) : (i == 0 ? 1.0 : 0.0);
  }
  EICOS_HD double h(int i) const {
    return add(t(i), mul(sgn, i == 0 ? 1.0 : 0.0));
  }
  EICOS_HD double H(int i, int j) const {
    return sub(i == j ? 1.0 : 0.0, mul(mul(inv, h(i)), h(j)));
  }
  EICOS_HD double rot(int i, int j) const {
    double v;
    if (d >= 2) {
      if (j == 0) v = i < 2 ? mul(1.0, r) : 0.0;
      else if (i == 0) v = mul(t(j - 1), r);
      else if (i == 1) v = mul(-t(j - 1), r);
      else v = H(j - 1, i - 1);
    } else {
      v = i == 0 && j == 0 ? 1.0 : 0.0;
    }
    return mul(mul(v, i < d ? 1.0 : 0.0), j < d ? 1.0 : 0.0);
  }
  // eigenvalue i: eta^2 (a + |q|)^2, eta^2 / (a + |q|)^2, then eta^2
  EICOS_HD double lam(int i, double a, double eta2) const {
    double v;
    if (d >= 2) {
      const double big = mul(add(a, nq), add(a, nq));
      v = i == 0 ? mul(eta2, big) : (i == 1 ? dvd(eta2, big) : eta2);
    } else {
      v = i == 0 ? eta2 : 0.0;
    }
    return mul(v, i < d ? 1.0 : 0.0);
  }
};

EICOS_HD ConeEig eig_cone(const double* q, int d, int D, double r) {
  ConeEig e{q, d, D, 0.0, 1.0, 0.0, r};
  double s2 = D > 1 ? mul(e.tq(0), e.tq(0)) : 0.0;
  for (int i = 1; i < D - 1; ++i) s2 = add(s2, mul(e.tq(i), e.tq(i)));
  e.nq = root(s2);
  e.sgn = D > 1 && e.t(0) >= 0.0 ? 1.0 : -1.0;
  double hh = D > 1 ? mul(e.h(0), e.h(0)) : 0.0;
  for (int i = 1; i < D - 1; ++i) hh = add(hh, mul(e.h(i), e.h(i)));
  e.inv = dvd(2.0, hh);
  return e;
}

// Row i of one cone's rot, lam, kept block -(diag(lam) + delta I) (kept
// may be null) and coupling rot G_soc: g (D, w) the cone's G_soc, the
// outputs at the cone's blocks.
EICOS_HD void eig_row(const ConeEig& e, int i, double a, double eta2,
                      double delta, const double* g, int w, double* rot,
                      double* lam, double* kept, double* coup) {
  const int D = e.D;
  double* r = rot + i * D;
  for (int j = 0; j < D; ++j) r[j] = e.rot(i, j);
  lam[i] = e.lam(i, a, eta2);
  if (kept) {
    for (int j = 0; j < D; ++j) {
      const double eye = i == j ? 1.0 : 0.0;
      const double eye_v = i == j && i < e.d ? 1.0 : 0.0;
      kept[i * D + j] = -add(mul(lam[i], eye), mul(delta, eye_v));
    }
  }
  for (int j = 0; j < w; ++j) {
    double acc = mul(r[0], g[j]);
    for (int k = 1; k < D; ++k) acc = add(acc, mul(r[k], g[k * w + j]));
    coup[i * w + j] = acc;
  }
}

// ------------------------------------------------------------ rotation

// Entry i of y = R x on one cone (R = rot, or rot' with `transpose`): x at
// the cone's head entry, d of the D slots live; the pad slots of x read 0.
EICOS_HD double rotate_row(const double* rot, const double* x, int d, int D,
                           bool transpose, int i) {
  double acc = 0.0;
  for (int k = 0; k < D; ++k) {
    const double rik = transpose ? rot[k * D + i] : rot[i * D + k];
    const double p = mul(rik, k < d ? x[k] : 0.0);
    acc = k == 0 ? p : add(acc, p);
  }
  return acc;
}

// ---------------------------------------------------------- line search

// cones.line_search's conic_norm of one cone's direction dv
EICOS_HD double conic_norm(const double* lam, const double* dv, int d,
                           int slots, double lknorm, double lknorminv) {
  const double lkbar0 = dvd(lam[0], lknorm);
  const double d0 = dv[0];
  double sd = mul(lkbar0, d0);
  for (int j = 1; j < d; ++j) sd = add(sd, mul(dvd(lam[j], lknorm), dv[j]));
  sd = pad(sd, d, slots);
  const double lkjd = sub(mul(mul(2.0, lkbar0), d0), sd);
  const double rho0 = mul(lknorminv, lkjd);
  const double factor = dvd(add(lkjd, d0), add(lkbar0, 1.0));
  double tt = mul(0.0, 0.0);
  for (int j = 1; j < d; ++j) {
    const double tj = mul(lknorminv, sub(dv[j],
                                         mul(factor, dvd(lam[j], lknorm))));
    tt = add(tt, mul(tj, tj));
  }
  tt = pad(tt, d, slots);
  return sub(root(tt), rho0);
}

// One cone's candidate step 1 / max(conic norms), inf where it allows any
// step (cones with |lam|_J^2 <= 0 are skipped): never NaN.
EICOS_HD double line_search_cone(const double* lam, const double* ds,
                                 const double* dz, int d, int slots) {
  const double l0 = lam[0];
  double ll = mul(l0, l0);
  for (int j = 1; j < d; ++j) ll = add(ll, mul(lam[j], lam[j]));
  ll = pad(ll, d, slots);
  const double lknorm2 = sub(mul(mul(2.0, l0), l0), ll);
  const bool in_cone = lknorm2 > 0.0;
  const double lknorm = root(in_cone ? lknorm2 : 1.0);
  const double lknorminv = dvd(1.0, lknorm);
  const double rhonorm = conic_norm(lam, ds, d, slots, lknorm, lknorminv);
  const double sigmanorm = conic_norm(lam, dz, d, slots, lknorm, lknorminv);
  double step = nmax(sigmanorm, rhonorm);
  if (!isnan_(step) && step < 0.0) step = 0.0;       // clamp(min=0)
  if (!in_cone) step = 0.0;
  return step > 0.0 ? dvd(1.0, step) : HUGE_VAL;
}

// The line search's end, from the LP ratio minima (rhomin, sigmamin; l the
// LP entries), the cones' least candidate and the tau, kappa terms.
EICOS_HD double line_search_end(int l, double rhomin, double sigmamin,
                                bool cones, double cand, double tau,
                                double dtau, double kap, double dkap,
                                double big, double alpha0, double stepmin,
                                double stepmax) {
  double alpha;
  if (l > 0) {
    alpha = -sigmamin > -rhomin
                ? (sigmamin < 0.0 ? dvd(1.0, -sigmamin) : big)
                : (rhomin < 0.0 ? dvd(1.0, -rhomin) : big);
  } else {
    alpha = alpha0;
  }
  const double mtd = dvd(-tau, dtau), mkd = dvd(-kap, dkap);
  if (mtd > 0.0 && mtd < alpha) alpha = mtd;
  if (mkd > 0.0 && mkd < alpha) alpha = mkd;
  if (cones) alpha = nmin(alpha, cand);
  if (isnan_(alpha)) return alpha;
  alpha = alpha < stepmin ? stepmin : alpha;
  return alpha > stepmax ? stepmax : alpha;
}

// ------------------------------------------- one thread's work a kernel

// The arguments of the entry points below, each kernel's in one struct.
struct ScalArgs {
  const double *s, *z;
  long long s_ls, z_ls;
  const int* offs;
  int l, n_sc, ms, slots;
  double *w_lp, *v_lp, *a, *q, *w, *eta, *eta2, *cc, *dd, *lam;
};

// item i of a lane: cone i, or LP entry i - n_sc
EICOS_HD void scalings_at(const ScalArgs& g, long long lane, int i) {
  const double* s = g.s + lane * g.s_ls;
  const double* z = g.z + lane * g.z_ls;
  double* lam = g.lam + lane * (g.l + g.ms);
  if (i < g.n_sc) {
    const int off = g.offs[i], d = g.offs[i + 1] - off;
    const ConeScal c = scalings_cone(s + g.l + off, z + g.l + off, d,
                                     g.slots, g.q + lane * g.ms + off,
                                     lam + g.l + off);
    const long long o = lane * g.n_sc + i;
    g.a[o] = c.a;
    g.w[o] = c.w;
    g.eta[o] = c.eta;
    g.eta2[o] = c.eta2;
    g.cc[o] = c.cc;
    g.dd[o] = c.dd;
  } else {
    const int j = i - g.n_sc;
    const double v = dvd(s[j], z[j]), wv = root(v);
    g.v_lp[lane * g.l + j] = v;
    g.w_lp[lane * g.l + j] = wv;
    lam[j] = mul(wv, z[j]);
  }
}

struct EigArgs {
  const double *q, *a, *eta2;
  const int* offs;
  const double* gsub;
  long long g_ls;
  int w, n_sc, ms, D;
  double r, delta;
  double *rot, *lam, *kept, *coup;
};

// row t % D of cone t / D
EICOS_HD void eig_at(const EigArgs& g, long long lane, int t) {
  const int D = g.D, k = t / D, i = t % D;
  const int off = g.offs[k], d = g.offs[k + 1] - off;
  const long long o = lane * g.n_sc + k;
  const ConeEig e = eig_cone(g.q + lane * g.ms + off, d, D, g.r);
  eig_row(e, i, g.a[o], g.eta2[o], g.delta,
          g.gsub + lane * g.g_ls + (long long)k * D * g.w, g.w,
          g.rot + o * D * D, g.lam + o * D,
          g.kept ? g.kept + o * D * D : nullptr, g.coup + o * D * g.w);
}

struct RotArgs {
  const double *rot, *x;
  long long x_ls, x_rs;
  const int* offs;
  int k, n_sc, ms, D, transpose;
  double* y;
};

// entry t % D of cone t / D of right-hand side `row` (lane row / k)
EICOS_HD void rotate_at(const RotArgs& g, long long row, int t) {
  const int D = g.D, c = t / D, i = t % D;
  const int off = g.offs[c], d = g.offs[c + 1] - off;
  if (i >= d) return;
  const long long lane = row / g.k, rhs = row % g.k;
  g.y[row * g.ms + off + i] = rotate_row(
      g.rot + (lane * g.n_sc + c) * D * D,
      g.x + lane * g.x_ls + rhs * g.x_rs + off, d, D, g.transpose != 0, i);
}

struct LsArgs {
  const double *lam, *ds, *dz, *tau, *dtau, *kap, *dkap;
  long long lam_ls, ds_ls, dz_ls, tau_s, dtau_s, kap_s, dkap_s;
  const int* offs;
  int l, n_sc, slots;
  double big, alpha0, stepmin, stepmax;
  double* out;
};

struct LsPart {
  double rhomin, sigmamin, cand;
};

// a lane's LP entries t, t + nt, ... and cones t, t + nt, ...
EICOS_HD LsPart line_search_part(const LsArgs& g, long long lane, int t,
                                 int nt) {
  const double* lam = g.lam + lane * g.lam_ls;
  const double* ds = g.ds + lane * g.ds_ls;
  const double* dz = g.dz + lane * g.dz_ls;
  LsPart p{HUGE_VAL, HUGE_VAL, HUGE_VAL};
  for (int j = t; j < g.l; j += nt) {
    p.rhomin = nmin(p.rhomin, dvd(ds[j], lam[j]));
    p.sigmamin = nmin(p.sigmamin, dvd(dz[j], lam[j]));
  }
  for (int c = t; c < g.n_sc; c += nt) {
    const int off = g.l + g.offs[c];
    p.cand = nmin(p.cand, line_search_cone(lam + off, ds + off, dz + off,
                                           g.offs[c + 1] - g.offs[c],
                                           g.slots));
  }
  return p;
}

EICOS_HD void line_search_out(const LsArgs& g, long long lane,
                              const LsPart& p) {
  g.out[lane] = line_search_end(
      g.l, p.rhomin, p.sigmamin, g.n_sc > 0, p.cand, g.tau[lane * g.tau_s],
      g.dtau[lane * g.dtau_s], g.kap[lane * g.kap_s],
      g.dkap[lane * g.dkap_s], g.big, g.alpha0, g.stepmin, g.stepmax);
}

#ifdef __CUDACC__

constexpr int NT = 128;      // threads a CTA: scalings, eig, rotate
constexpr int NT_LS = 256;   // line search: one CTA a lane

// grids: blockIdx.x the lane (a right-hand side of one in cone_rotate),
// blockIdx.y a block of NT items of it
__global__ void __launch_bounds__(NT) scalings_kernel(const ScalArgs g) {
  const int i = blockIdx.y * NT + threadIdx.x;
  if (i < g.n_sc + g.l) scalings_at(g, blockIdx.x, i);
}

__global__ void __launch_bounds__(NT) eig_kernel(const EigArgs g) {
  const int t = blockIdx.y * NT + threadIdx.x;
  if (t < g.n_sc * g.D) eig_at(g, blockIdx.x, t);
}

__global__ void __launch_bounds__(NT) rotate_kernel(const RotArgs g) {
  const int t = blockIdx.y * NT + threadIdx.x;
  if (t < g.n_sc * g.D) rotate_at(g, blockIdx.x, t);
}

// the CTA's NaN-propagating minimum of v, in every thread
__device__ double block_min(double v, double* red) {
  for (int o = 16; o; o >>= 1)
    v = nmin(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  v = red[0];
  for (int i = 1; i < NT_LS / 32; ++i) v = nmin(v, red[i]);
  return v;
}

__global__ void __launch_bounds__(NT_LS) line_search_kernel(const LsArgs g) {
  __shared__ double red[NT_LS / 32];
  LsPart p = line_search_part(g, blockIdx.x, threadIdx.x, NT_LS);
  p.rhomin = block_min(p.rhomin, red);
  p.sigmamin = block_min(p.sigmamin, red);
  p.cand = block_min(p.cand, red);
  if (threadIdx.x == 0) line_search_out(g, blockIdx.x, p);
}

unsigned blocks(long long n, int nt) { return (unsigned)((n + nt - 1) / nt); }

#endif  // __CUDACC__

}  // namespace

// The entry points.  Each launches its kernel on `stream` and returns the
// CUDA error code of the launch; inputs are f64 with unit column stride,
// the outputs contiguous f64 (see the layout above).  Built without nvcc,
// each runs its threads' work one after another on the host and returns 0.

// cones.update_scalings and lam = W z: s, z (lanes, l + ms) with lane
// strides; outputs w_lp, v_lp (lanes, l), a, w, eta, eta2, cc, dd (lanes,
// n_sc), q (lanes, ms), lam (lanes, l + ms).  slots: the largest cone
// dimension.
extern "C" int eicos_cone_scalings(const double* s, long long s_ls,
                                   const double* z, long long z_ls,
                                   const int* offs, int lanes, int l,
                                   int n_sc, int ms, int slots,
                                   double* w_lp, double* v_lp, double* a,
                                   double* q, double* w, double* eta,
                                   double* eta2, double* cc, double* dd,
                                   double* lam, void* stream) {
  const ScalArgs g{s, z, s_ls, z_ls, offs, l, n_sc, ms, slots, w_lp, v_lp,
                   a, q, w, eta, eta2, cc, dd, lam};
  if (lanes == 0 || n_sc + l == 0) return 0;
#ifdef __CUDACC__
  dim3 grid((unsigned)lanes, blocks(n_sc + l, NT));
  scalings_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
#else
  for (long long lane = 0; lane < lanes; ++lane)
    for (int i = 0; i < n_sc + l; ++i) scalings_at(g, lane, i);
  return 0;
#endif
}

// kkt._soc_eig, _soc_kept_vals and _soc_coupling_vals: q (lanes, ms), a and
// eta2 (lanes, n_sc) contiguous; gsub (n_sc, D, w), shared (g_ls 0) or a
// lane's at g_ls; r = sqrt(1/2) as the plain path rounds it.  kept null:
// not computed.
extern "C" int eicos_cone_eig(const double* q, const double* a,
                              const double* eta2, const int* offs,
                              const double* gsub, long long g_ls, int w,
                              int lanes, int n_sc, int ms, int D, double r,
                              double delta, double* rot, double* lam,
                              double* kept, double* coup, void* stream) {
  const EigArgs g{q, a, eta2, offs, gsub, g_ls, w, n_sc, ms, D, r, delta,
                  rot, lam, kept, coup};
  if (lanes == 0 || n_sc == 0) return 0;
#ifdef __CUDACC__
  dim3 grid((unsigned)lanes, blocks((long long)n_sc * D, NT));
  eig_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
#else
  for (long long lane = 0; lane < lanes; ++lane)
    for (int t = 0; t < n_sc * D; ++t) eig_at(g, lane, t);
  return 0;
#endif
}

// kkt._soc_rotate: y (lanes, k, ms) = rot x (rot' x with transpose) cone by
// cone; rot (lanes, n_sc, D, D) contiguous, x (lanes, k, ms) at lane and
// row strides.
extern "C" int eicos_cone_rotate(const double* rot, const double* x,
                                 long long x_ls, long long x_rs,
                                 const int* offs, int lanes, int k, int n_sc,
                                 int ms, int D, int transpose, double* y,
                                 void* stream) {
  const RotArgs g{rot, x, x_ls, x_rs, offs, k, n_sc, ms, D, transpose, y};
  if (lanes == 0 || k == 0 || n_sc == 0) return 0;
#ifdef __CUDACC__
  dim3 grid((unsigned)((long long)lanes * k),
            blocks((long long)n_sc * D, NT));
  rotate_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
#else
  for (long long row = 0; row < (long long)lanes * k; ++row)
    for (int t = 0; t < n_sc * D; ++t) rotate_at(g, row, t);
  return 0;
#endif
}

// cones.line_search: lam, ds, dz (lanes, l + ms) at lane strides; tau,
// dtau, kap, dkap (lanes,) at strides; out (lanes,).  big = 1 / 1e-13 and
// alpha0 = 10 as the plain path rounds them.  One CTA a lane.
extern "C" int eicos_cone_line_search(
    const double* lam, long long lam_ls, const double* ds, long long ds_ls,
    const double* dz, long long dz_ls, const double* tau, long long tau_s,
    const double* dtau, long long dtau_s, const double* kap, long long kap_s,
    const double* dkap, long long dkap_s, const int* offs, int lanes, int l,
    int n_sc, int slots, double big, double alpha0, double stepmin,
    double stepmax, double* out, void* stream) {
  const LsArgs g{lam,    ds,     dz,    tau,   dtau,   kap,    dkap,
                 lam_ls, ds_ls,  dz_ls, tau_s, dtau_s, kap_s,  dkap_s,
                 offs,   l,      n_sc,  slots, big,    alpha0, stepmin,
                 stepmax, out};
  if (lanes == 0) return 0;
#ifdef __CUDACC__
  line_search_kernel<<<(unsigned)lanes, NT_LS, 0, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
#else
  for (long long lane = 0; lane < lanes; ++lane)
    line_search_out(g, lane, line_search_part(g, lane, 0, 1));
  return 0;
#endif
}
