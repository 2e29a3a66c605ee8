"""The port's substitution path (ops/dense.py, ``ldl_factor_subst``,
``dense_solve="subst"``) and its float32 path (the f32 leaf,
``factor_dtype="float32"``) on the CPU, where each wrapper runs its plain
version, against the JAX package: the Pallas kernels they replace in
interpret mode (K15/K16 through ``ldl_factor_subst`` + ``dense_solve_ds``,
K11 through ``leaf_ldl_pallas``) and the f64 recursion that the JAX
package runs on the CPU.

Tolerances: against ``np.linalg.solve`` and the double-single TPU kernels
(about 2^-48 an operation) 1e-9 in the 2-norm, the reference's own bar for
them (``tests/test_dense_ds.py``); against the f64 inverse path, which
differs in summation order only, 1e-12; the factor's pieces against the
JAX function's 1e-12, and its pivots equal to ``ldl_factor``'s bit for bit.
The f32 leaves are held to each other at 2e-4 relative (both compute in
f32, eps 6e-8, over 128 dependent steps, in different orders; the
reference's own test allows 5e-3) and to the f64 leaf at the same.  Whole
f32 solves: an f32 factor leaves refinement short of its threshold, so
late iterations turn on the last bits and the two packages' exit codes
scatter both ways across problems; the directions after refinement are
compared instead (1e-9), and whole solves on problems where both end in
the same tier (objective 1e-6)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eicos_tpu as jt
from eicos_tpu import cones as jcones
from eicos_tpu import corpus as jcorpus
from eicos_tpu import kkt as jkkt
from eicos_tpu.api import BatchedSolver as JBatched
from eicos_tpu.equilibrate import equilibrate as jequil
from eicos_tpu.ops import ldl as jldl
from eicos_tpu.ops.pallas_band_ds import KP
from eicos_tpu.ops.pallas_dense_ds import dense_solve_ds, prechunk_dense
from eicos_tpu.ops.pallas_leaf import leaf_ldl_pallas
from eicos_tpu.settings import Settings as JSettings

import eicos_tpu_torch as pt
from eicos_tpu_torch import cones, kkt, problem
from eicos_tpu_torch.api import _code_rank
from eicos_tpu_torch.equilibrate import equilibrate
from eicos_tpu_torch.ops import dense, ldl, leaf
from eicos_tpu_torch.settings import Settings

B = 128
SHARED = ("G", "A", "h")


def quasidefinite(rng, D, split=None):
    """The reference's test matrix (``tests/test_dense_ds.py``): positive
    definite leading block, negative definite trailing block, mild
    coupling."""
    split = split if split is not None else (2 * D) // 3
    A1 = rng.standard_normal((split, split))
    A2 = rng.standard_normal((D - split, D - split))
    C = 0.1 * rng.standard_normal((D - split, split))
    K = np.zeros((D, D))
    K[:split, :split] = A1 @ A1.T + D * np.eye(split)
    K[split:, split:] = -(A2 @ A2.T + D * np.eye(D - split))
    K[split:, :split] = C
    K[:split, split:] = C.T
    return K


def reference_subst(K):
    """(Loff, Xinv, d) of the JAX package's substitution recursion."""
    with jax.default_matmul_precision("highest"):
        _, Xinv, Loff, d = jldl._ldl_rec_subst(jnp.asarray(K), B, False)
    return Loff, Xinv, d


def fac_from_reference(Loff, Xinv, d) -> dense.DenseFac:
    """A JAX substitution factor's pieces, one lane, packed for the port's
    sweeps."""
    t = torch.tensor
    return dense.pack_dense(t(np.asarray(Loff))[None],
                            t(np.asarray(Xinv))[None], t(np.asarray(d))[None])


def norm_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_pack_plain_block_order():
    """Block [k, c], c < k, lands at index k (k-1) / 2 + c; blocks on and
    above the diagonal are never read."""
    rng = np.random.default_rng(0)
    nb = 4
    M = rng.standard_normal((2, nb * B, nb * B))
    Lp = dense.pack_dense_plain(torch.tensor(M))
    assert Lp.shape == (2, nb * (nb - 1) // 2, B, B) and Lp.is_contiguous()
    for k in range(1, nb):
        for c in range(k):
            want = M[:, k * B:(k + 1) * B, c * B:(c + 1) * B]
            assert np.array_equal(Lp[:, k * (k - 1) // 2 + c].numpy(), want)
    one = dense.pack_dense(torch.tensor(M[:, :B, :B]), torch.zeros(2, 1, B, B),
                           torch.ones(2, B))
    assert one.Lp.shape == (2, 0, B, B)


@pytest.mark.parametrize("D", [128, 384])
def test_sweeps_plain_match_numpy_and_kernels(D):
    """K15/K16: the JAX factor's pieces through ``pack_dense`` and the
    plain sweeps, against ``np.linalg.solve``, against the TPU kernels on
    the prechunked factor in interpret mode, and against the port's f64
    inverse solve."""
    rng = np.random.default_rng(0)
    K = quasidefinite(rng, D)
    rhs = rng.standard_normal((3, D))
    Loff, Xinv, d = reference_subst(K)
    fac = fac_from_reference(Loff, Xinv, d)
    x = dense.dense_solve(fac, torch.tensor(rhs)[None])[0].numpy()
    assert norm_err(x, np.linalg.solve(K, rhs.T).T) < 1e-9
    pre = prechunk_dense(Loff, Xinv, d)
    rhs_t = jnp.zeros((KP, D)).at[:3].set(jnp.asarray(rhs))
    x_j = np.asarray(dense_solve_ds(pre, rhs_t, interpret=True))[:3]
    assert norm_err(x, x_j) < 1e-9
    inv = ldl.ldl_factor(torch.tensor(K)[None].clone())
    assert rel(x, ldl.ldl_solve(inv, torch.tensor(rhs)[None])[0]) < 1e-12
    # the two sweeps one by one: w = L^-1 b / d, then z = L^-T w
    L = np.asarray(Loff) + np.linalg.inv(
        np.asarray(jax.scipy.linalg.block_diag(*Xinv)))
    w = dense.dense_fwd(fac, torch.tensor(rhs)[None])[0].numpy()
    assert rel(w, np.linalg.solve(L, rhs.T).T / np.asarray(d)) < 1e-12
    z = dense.dense_bwd(fac, torch.tensor(w)[None])[0].numpy()
    assert rel(z, np.linalg.solve(L.T, w.T).T) < 1e-12


@pytest.mark.parametrize("D", [384, 640])
def test_ldl_factor_subst_matches_jax(D):
    """``_ldl_rec_subst``'s L panels, leaf inverses and pivots against the
    JAX function's, lane by lane; the pivots and leaf inverses have the
    bits of the port's ``ldl_factor``; one solve's residual."""
    rng = np.random.default_rng(D)
    K = np.stack([quasidefinite(rng, D) for _ in range(2)])
    fac = ldl.ldl_factor_subst(torch.tensor(K).clone())
    inv = ldl.ldl_factor(torch.tensor(K).clone())
    assert isinstance(fac, ldl.LDLSubstFactors)
    assert torch.equal(fac.d, inv.d) and fac.pre.d is fac.d
    nb = D // B
    for i in range(nb):
        assert torch.equal(fac.pre.Xinv[:, i],
                           inv.Linv[:, i * B:(i + 1) * B, i * B:(i + 1) * B])
    for lane in range(2):
        Loff, Xinv, d = reference_subst(K[lane])
        assert rel(fac.d[lane], d) < 1e-12
        assert rel(fac.pre.Xinv[lane], Xinv) < 1e-12
        want = dense.pack_dense_plain(torch.tensor(np.asarray(Loff))[None])[0]
        assert rel(fac.pre.Lp[lane], want) < 1e-12
    rhs = np.random.default_rng(9).standard_normal((2, 16, D))
    x = ldl.ldl_solve(fac, torch.tensor(rhs)).numpy()
    resid = np.einsum("lij,lkj->lki", K, x) - rhs
    assert np.abs(resid).max() / np.abs(rhs).max() < 1e-12
    assert rel(x, ldl.ldl_solve(inv, torch.tensor(rhs))) < 1e-12


def test_ldl_factor_subst_rejects():
    with pytest.raises(ValueError):
        ldl.ldl_factor_subst(torch.zeros(1, 200, 200, dtype=torch.float64))
    with pytest.raises(ValueError):
        ldl.ldl_factor_subst(torch.zeros(1, B, B, dtype=torch.float32))


@pytest.mark.parametrize("strategy,solve,device,dtype,want", [
    ("reduced", "auto", "cpu", torch.float64, False),
    ("reduced", "auto", "cuda", torch.float64, True),
    ("normal", "auto", "cuda", torch.float64, True),
    ("full", "auto", "cuda", torch.float64, False),
    ("full", "subst", "cuda", torch.float64, True),
    ("reduced", "subst", "cpu", torch.float64, True),
    ("reduced", "inverse", "cuda", torch.float64, False),
    ("reduced", "subst", "cuda", torch.float32, False),
])
def test_use_subst_routing(strategy, solve, device, dtype, want):
    """``dense_solve="auto"`` follows the tensor's device; "full" leaves
    the inverse path only when asked; f32 never does."""
    K = types.SimpleNamespace(dtype=dtype,
                              device=types.SimpleNamespace(type=device))
    s = Settings(kkt_strategy=strategy, dense_solve=solve)
    assert kkt._use_subst(K, s) is want


def small_case(kind):
    if kind == "soc":
        jst, d = jcorpus.make_mpc_soc(horizon=6, nx=2, nu=2, seed=5)
    else:
        jst, d = jcorpus.make_mpc_like(horizon=10, nx=2, nu=4, seed=3)
    return jst.with_gsplit(d.G, d.A), d


def lanes_of(base, n, seed, count=2):
    rng = np.random.default_rng(seed)
    probs = []
    for _ in range(count):
        c = np.asarray(base.c) + 0.02 * rng.standard_normal(n)
        b = np.asarray(base.b).copy()
        b[:2] += 0.05 * rng.standard_normal(2)
        probs.append(dict(G=np.asarray(base.G), A=np.asarray(base.A), c=c,
                          h=np.asarray(base.h), b=b))
    return probs


def solve_both(jst, base, cfg, seed=7):
    """The same two lanes through both packages' ``BatchedSolver``."""
    probs = lanes_of(base, jst.n, seed)
    jbatch = JBatched.stack([jt.ProblemData(**p) for p in probs],
                            shared=SHARED)
    st, _ = problem.from_reference(problem.structure_fields(jst), base.G,
                                   base.A, base.c, base.h, base.b)
    pbatch = pt.BatchedSolver.stack([problem.ProblemData(**p)
                                     for p in probs], shared=SHARED)
    ref = JBatched(jst, JSettings(**cfg), shared=SHARED).solve(jbatch)
    sol = pt.BatchedSolver(st, pt.Settings(**cfg), shared=SHARED,
                           device="cpu").solve(pbatch)
    return sol, ref


def assert_lanes_match(sol, ref, tol=1e-8):
    np.testing.assert_array_equal(sol.exit_code.numpy(),
                                  np.asarray(ref.exit_code))
    np.testing.assert_array_equal(sol.info.iter.numpy(),
                                  np.asarray(ref.info.iter))
    want = np.asarray(ref.info.pcost)
    assert np.all(np.abs(sol.info.pcost.numpy() - want) <= tol * np.abs(want))


def assert_same_tier(sol, ref, tol):
    """Lane by lane the exit tier of the JAX package (definitive, reduced
    accuracy, failure), none a failure, and its objective within tol."""
    got = [_code_rank(int(c)) for c in sol.exit_code.numpy()]
    want = [_code_rank(int(c)) for c in np.asarray(ref.exit_code)]
    assert got == want and min(want) >= 1
    pc = np.asarray(ref.info.pcost)
    assert np.all(np.abs(sol.info.pcost.numpy() - pc) <= tol * np.abs(pc))


@pytest.mark.parametrize("kind", ["lp", "soc"])
@pytest.mark.parametrize("strategy", ["reduced", "normal"])
def test_batched_subst_matches(kind, strategy):
    """Whole solves under ``dense_solve="subst"`` (the plain pack and
    sweeps) against the JAX package, whose CPU solves take the f64 inverse
    path: exit code, iteration count, objective at 1e-8."""
    jst, base = small_case(kind)
    sol, ref = solve_both(jst, base, dict(kkt_strategy=strategy,
                                          dense_solve="subst"))
    if strategy == "reduced":
        assert np.all(np.asarray(ref.exit_code) == 0)
    if (kind, strategy) == ("soc", "normal"):
        # eliminating the cones squares their conditioning: both packages
        # end these lanes at CLOSE_TO_OPTIMAL, an iteration apart
        assert_same_tier(sol, ref, 1e-6)
    else:
        assert_lanes_match(sol, ref)


def test_subst_launches_nothing_on_cpu_and_counts_exist():
    from eicos_tpu_torch.ops import kernels

    for name in ("dense_pack", "dense_fwd", "dense_bwd", "leaf_ldl_f32"):
        assert name in kernels.COUNTS
    assert {"dense_pack", "dense_solve", "leaf_ldl_f32"} <= set(kernels.LIBS)
    before = dict(kernels.COUNTS)
    K = quasidefinite(np.random.default_rng(1), 256)
    fac = ldl.ldl_factor_subst(torch.tensor(K)[None])
    ldl.ldl_solve(fac, torch.ones(1, 2, 256, dtype=torch.float64))
    assert kernels.COUNTS == before


# ------------------------------------------------------------------ float32

@pytest.fixture(scope="module")
def leaves32():
    """3 blocks A A' + 128 I and one mixed-sign quasidefinite block."""
    rng = np.random.default_rng(11)
    blocks = []
    for _ in range(3):
        A = rng.standard_normal((B, B))
        blocks.append(A @ A.T + B * np.eye(B))
    blocks.append(quasidefinite(rng, B, split=80))
    return np.stack(blocks)


def test_leaf_f32_plain_matches_kernel(leaves32):
    """K11 (``leaf_ldl_pallas``, interpret mode) against the plain f32
    leaf, and both against the f64 leaf."""
    M32 = leaves32.astype(np.float32)
    Linv_j, d_j = leaf_ldl_pallas(jnp.asarray(M32), interpret=True)
    Linv, d = leaf.leaf_ldl(torch.tensor(M32))
    assert Linv.dtype == torch.float32 and d.dtype == torch.float32
    Linv64, d64 = leaf.leaf_ldl(torch.tensor(leaves32))
    for i in range(len(M32)):
        assert rel(d[i], d_j[i]) < 2e-4, i
        assert rel(Linv[i], Linv_j[i]) < 2e-4, i
        assert rel(d[i], d64[i]) < 2e-4, i
        assert rel(Linv[i], Linv64[i]) < 2e-4, i
    assert torch.all(torch.triu(Linv, 1) == 0.0)


def test_leaf_f32_clamps_pivots():
    """|d| < 1e-20 is clamped to +-1e-20, as the reference's XLA f32 leaf
    does (its Pallas leaf does not clamp)."""
    M = torch.eye(B, dtype=torch.float32)[None].clone()
    M[0, 5, 5] = 0.0
    M[0, 9, 9] = -1e-30
    Linv, d = leaf.leaf_ldl(M)
    assert float(d[0, 5]) == np.float32(1e-20)
    assert float(d[0, 9]) == -np.float32(1e-20)
    assert torch.isfinite(Linv).all()
    _, d_j = jldl._unblocked_ldl(jnp.asarray(M[0].numpy()))
    assert np.array_equal(np.asarray(d_j), d[0].numpy())


def test_ldl_factor_f32_matches_jax():
    """The f32 recursion (plain leaf, ``torch.matmul``) and its solve
    against the JAX package's f32 ``ldl_factor`` / ``ldl_solve``."""
    rng = np.random.default_rng(3)
    K = quasidefinite(rng, 384).astype(np.float32)
    ref = jldl.ldl_factor(jnp.asarray(K))
    fac = ldl.ldl_factor(torch.tensor(K)[None].clone())
    assert fac.Linv.dtype == torch.float32
    assert rel(fac.d[0], ref.d) < 1e-4 and rel(fac.Linv[0], ref.Linv) < 1e-4
    rhs = rng.standard_normal((2, 384)).astype(np.float32)
    x = ldl.ldl_solve(fac, torch.tensor(rhs)[None])
    assert x.dtype == torch.float32
    assert rel(x[0], np.asarray(jldl.ldl_solve(ref, jnp.asarray(rhs.T))).T) \
        < 1e-4
    resid = x[0].numpy().astype(np.float64) @ K.astype(np.float64) - rhs
    assert np.abs(resid).max() / np.abs(rhs).max() < 1e-4


@pytest.mark.parametrize("strategy", ["reduced", "normal", "full"])
@pytest.mark.parametrize("scaled", [False, True])
def test_f32_refined_solve_matches(strategy, scaled):
    """One factor in f32 and one refined solve on the SOCP: the raw f32
    directions agree to f32 rounding (1e-5), the refined ones to 1e-9."""
    jst, d = small_case("soc")
    st, pd = problem.from_reference(problem.structure_fields(jst), d.G, d.A,
                                    d.c, d.h, d.b)
    cfg = dict(kkt_strategy=strategy, factor_dtype="float32")
    jset, pset = JSettings(**cfg), Settings(**cfg)
    jeq = jequil(jst, *[jnp.asarray(getattr(d, f)) for f in "GAchb"])
    t = torch.tensor
    peq = equilibrate(st, t(pd.G), t(pd.A), t(pd.c)[None], t(pd.h)[None],
                      t(pd.b)[None])
    jctx = jkkt.make_context(jst, jeq.G, jeq.A, jset)
    pctx = kkt.make_context(st, peq.G, peq.A, pset)
    jscal = pscal = None
    if scaled:
        rng = np.random.default_rng(5)
        s = rng.random(st.m) + 0.5
        z = rng.random(st.m) + 0.5
        heads = st.l + np.asarray(st.cone.head_offsets)
        s[heads] += 3.0
        z[heads] += 3.0
        jscal, _ = jcones.update_scalings(jst.cone, jnp.asarray(s),
                                          jnp.asarray(z))
        pscal, _ = cones.update_scalings(st.cone, t(s)[None], t(z)[None])
    n, p, m = st.n, st.p, st.m
    rng = np.random.default_rng(6)
    rhs = np.stack([
        np.concatenate([np.zeros(n), np.asarray(jeq.b), np.asarray(jeq.h)]),
        rng.standard_normal(n + p + m)])
    js = jkkt.factor(jst, jctx, jscal, jset)
    ps = kkt.factor(st, pctx, pscal, pset, 1)
    raw_j, raw_p = js(jnp.asarray(rhs)), ps(t(rhs)[None])
    for a, b in zip(raw_p, raw_j):
        assert a.dtype == torch.float64
        assert rel(a[0], b) < 1e-5
    ref = jkkt.solve_refined(jst, jctx, js, jscal, jnp.asarray(rhs), jset)
    got = kkt.solve_refined(st, pctx, ps, pscal, t(rhs)[None], pset)
    for f in ("dx", "dy", "dz"):
        assert rel(getattr(got, f)[0], getattr(ref, f)) < 1e-9, f


@pytest.mark.parametrize("kind,horizon,seed,strategy", [
    ("soc", 6, 1, "reduced"), ("soc", 6, 1, "full"),
    ("lp", 4, 2, "reduced"), ("lp", 12, 4, "normal")])
def test_f32_whole_solve_same_tier(kind, horizon, seed, strategy):
    """Whole solves under an f32 factor on problems whose late iterations
    do not turn on the last bits: the exit tier of the JAX package and,
    where that is not a failure, its objective at 1e-6."""
    make = jcorpus.make_mpc_soc if kind == "soc" else jcorpus.make_mpc_like
    jst, d = make(horizon=horizon, nx=2, nu=2, seed=seed)
    if strategy != "full":
        jst = jst.with_gsplit(d.G, d.A)
    st, pd = problem.from_reference(problem.structure_fields(jst), d.G, d.A,
                                    d.c, d.h, d.b)
    cfg = dict(kkt_strategy=strategy, factor_dtype="float32")
    ref = jt.solve(jst, d, jt.Settings(**cfg))
    sol = pt.solve(st, pd, pt.Settings(**cfg), device="cpu")
    assert _code_rank(int(sol.exit_code)) == _code_rank(int(ref.exit_code))
    assert _code_rank(int(ref.exit_code)) >= 1
    want = float(ref.info.pcost)
    assert abs(float(sol.info.pcost) - want) <= 1e-6 * abs(want)
