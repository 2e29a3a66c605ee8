"""The reference's test corpus and the benchmark families: the port of
``eicos_tpu.corpus``.

EiCOS ships its test problems as C headers with CSC arrays (its
``test/*/*.h``, driven through the ECOS shim ``test/ecos.h`` by
``test/ecostester.cpp:52-72``).  ``parse_header`` reads such a header,
``load`` turns a registered problem (``CORPUS``) into (ProblemStructure,
ProblemData, expected exit codes) and ``load_update_data`` reads the
updateData double solve; all three give what ``eicos_tpu.corpus`` gives.
The headers are read from ``REFERENCE_TEST_DIR``: the environment variable
``EICOS_REFERENCE_TESTS``, else ``reference/test`` inside this checkout
(where an EiCOS ``test`` directory may be copied or linked).  Nothing
outside the checkout is read unless the variable names it.

MPC01 is a missing large blob of the reference snapshot;
``make_mpc_like`` regenerates a problem of the same family (LP-form MPC,
the family of MPC02: n=1496, m=3996, p=499, EiCOS test/MPC/MPC02.h:4-8),
and ``make_mpc_soc`` its SOC-constrained variant.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import re

import numpy as np

from . import native
from .exitcodes import ExitCode
from .problem import make_problem
from .structure import ProblemStructure

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_TEST_DIR = os.environ.get(
    "EICOS_REFERENCE_TESTS", os.path.join(_REPO, "reference", "test"))

_SCALAR_RE = re.compile(
    r"\bidxint\s+(\w+)\s*=\s*(-?\d+)\s*;")
_ARRAY_RE = re.compile(
    r"\b(?:static\s+)?(?:pfloat|idxint)\s+(\w+)\s*\[\s*\d*\s*\]\s*=\s*\{(.*?)\}\s*;",
    re.DOTALL)
_NULL_RE = re.compile(r"\b(?:pfloat|idxint)\s*\*\s*(\w+)\s*=\s*NULL\s*;")
_FLOATVAL_RE = re.compile(r"\bpfloat\s+(\w+)\s*=\s*(-?[\d.eE+-]+)\s*;")
_ARRAY_HEAD_RE = re.compile(
    r"\b(?:static\s+)?(?:pfloat|idxint)\s+(\w+)\s*\[\s*\d*\s*\]\s*=\s*\{")


def parse_header(path: str) -> dict:
    """Every scalar, array and NULL definition of a C data header: ints,
    floats, f64 arrays and None.  Array bodies are scanned by the native
    parser (``native.parse_numbers``) when the library is loaded, else by
    the regex fallback.  A missing file raises ``FileNotFoundError``
    naming its path."""
    with open(path, "rb") as f:
        raw = f.read()
    text = raw.decode()
    out: dict = {}
    for name, val in _SCALAR_RE.findall(text):
        out[name] = int(val)
    for name, val in _FLOATVAL_RE.findall(text):
        out[name] = float(val)
    # str offsets are byte offsets only in a pure-ASCII file
    if native.available() and len(raw) == len(text):
        for mt in _ARRAY_HEAD_RE.finditer(text):
            vals, _ = native.parse_numbers(raw, mt.end())
            out[mt.group(1)] = vals
    else:
        for name, body in _ARRAY_RE.findall(text):
            vals = [v for v in re.split(r"[,\s]+", body.strip()) if v]
            out[name] = np.array([float(v) for v in vals])
    for name in _NULL_RE.findall(text):
        out[name] = None
    return out


@dataclasses.dataclass(frozen=True)
class CorpusEntry:
    name: str
    file: str            # relative to REFERENCE_TEST_DIR
    prefix: str          # variable name prefix ('' for inline names)
    expected: tuple      # acceptable ExitCode values
    dims: tuple | None = None  # (n, m, p, l, ncones) when literal in the test
    names: dict | None = None  # variable-name overrides


# The tests registered in EiCOS's runner (test/ecostester.cpp:54-72), less
# the missing-blob MPC01, plus infeasible2 (in the tree, not registered:
# a case with equalities).  Expected codes from each header's mu_assert.
_OPT = (ExitCode.OPTIMAL,)
_OPT_IN = (ExitCode.OPTIMAL, ExitCode.CLOSE_TO_OPTIMAL)

CORPUS = [
    CorpusEntry("MPC02", "MPC/MPC02.h", "MPC02_", _OPT_IN),
    CorpusEntry("unboundedLP1", "unboundedProblems/unboundedLP1.h", "",
                (ExitCode.DUAL_INFEASIBLE,)),
    CorpusEntry("unboundedMaxSqrt", "unboundedProblems/unboundedMaxSqrt.h",
                "", (ExitCode.DUAL_INFEASIBLE,)),
    CorpusEntry("feas", "feasibilityProblems/feas.h", "feas_", _OPT,
                dims=(1, 2, 0, 2, 0),
                names={"Gpr": "feas_Gx", "Gjc": "feas_Gp", "Gir": "feas_Gi"}),
    CorpusEntry("infeasible1", "infeasibleProblems/infeasible1.h", "",
                (ExitCode.PRIMAL_INFEASIBLE,)),
    CorpusEntry("infeasible2", "infeasibleProblems/infeasible2.h", "",
                (ExitCode.PRIMAL_INFEASIBLE,)),
    CorpusEntry("emptyProblem", "emptyProblem/emptyProblem.h", "", _OPT,
                dims=(0, 0, 0, 0, 0)),
    CorpusEntry("issue98", "cvxpyProblems/githubIssue98.h", "", _OPT,
                dims=(5, 11, 0, 6, 1),
                names={"Gpr": "Gx", "Gjc": "Gp", "Gir": "Gi"}),
    CorpusEntry("lp_afiro", "LPnetlib/lp_afiro.h", "lp_afiro_", _OPT),
    CorpusEntry("lp_adlittle", "LPnetlib/lp_adlittle.h", "lp_adlittle_", _OPT),
    CorpusEntry("lp_blend", "LPnetlib/lp_blend.h", "lp_blend_", _OPT),
    CorpusEntry("lp_beaconfd", "LPnetlib/lp_beaconfd.h", "lp_beaconfd_", _OPT),
    CorpusEntry("lp_bandm", "LPnetlib/lp_bandm.h", "lp_bandm_", _OPT),
    CorpusEntry("lp_agg", "LPnetlib/lp_agg.h", "lp_agg_", _OPT),
    CorpusEntry("lp_agg2", "LPnetlib/lp_agg2.h", "lp_agg2_", _OPT),
    CorpusEntry("lp_agg3", "LPnetlib/lp_agg3.h", "lp_agg3_", _OPT),
    CorpusEntry("lp_bnl1", "LPnetlib/lp_bnl1.h", "lp_bnl1_", _OPT),
    CorpusEntry("lp_25fv47", "LPnetlib/lp_25fv47.h", "lp_25fv47_", _OPT),
]

# update_data: two datasets over one structure (a double solve)
UPDATE_DATA_ENTRY = CorpusEntry(
    "update_data", "updateData/update_data.h", "udd_", _OPT_IN)


def _get(d, entry: CorpusEntry, key: str):
    if entry.names and key in entry.names:
        return d.get(entry.names[key])
    return d.get(entry.prefix + key)


@functools.lru_cache(maxsize=None)
def load(name: str):
    """A corpus problem -> (structure, ProblemData, expected codes); the
    data as NumPy f64 arrays.  An unknown name raises ``KeyError``."""
    entry = next((e for e in CORPUS if e.name == name), None)
    if entry is None:
        raise KeyError(f"no corpus problem {name!r}")
    d = parse_header(os.path.join(REFERENCE_TEST_DIR, entry.file))

    if entry.dims is not None:
        n, m, p, l, ncones = entry.dims
    else:
        n, m, p, l, ncones = (int(_get(d, entry, k))
                              for k in ("n", "m", "p", "l", "ncones"))
    qarr = _get(d, entry, "q")
    if qarr is None and ncones and "q" in d:
        qarr = d["q"]
    q = tuple(int(v) for v in np.asarray(qarr)[:ncones]) if ncones else ()

    G = _csc_to_dense(m, n, _get(d, entry, "Gpr"), _get(d, entry, "Gjc"),
                      _get(d, entry, "Gir"))
    A = _csc_to_dense(p, n, _get(d, entry, "Apr"), _get(d, entry, "Ajc"),
                      _get(d, entry, "Air"))
    st = ProblemStructure.create(n, p, m, l, q)
    prob = make_problem(st, G, A, _get(d, entry, "c"), _get(d, entry, "h"),
                        _get(d, entry, "b"))
    return st, prob, entry.expected


def _csc_to_dense(m, n, pr, jc, ir):
    """The dense (m, n) matrix of CSC arrays (zeros for ``pr=None``), as
    ``eicos_tpu.corpus`` forms it (SciPy sums repeated entries)."""
    if pr is None or n == 0 or m == 0:
        return np.zeros((m, n))
    import scipy.sparse as sp

    return sp.csc_matrix(
        (np.asarray(pr, float), np.asarray(ir, int), np.asarray(jc, int)),
        shape=(m, n)).toarray()


@functools.lru_cache(maxsize=None)
def load_update_data():
    """The updateData double solve (EiCOS test/updateData/update_data.h:
    1657-1688): (structure, data 1, data 2, optval 1, optval 2), the two
    datasets over one structure."""
    d = parse_header(os.path.join(REFERENCE_TEST_DIR,
                                  UPDATE_DATA_ENTRY.file))
    n, m, p, l = d["udd_n"], d["udd_m"], d["udd_p"], d["udd_l"]
    st = ProblemStructure.create(n, p, m, l, ())
    probs = []
    for k in ("1", "2"):
        G = _csc_to_dense(m, n, d[f"udd_G{k}pr"], d["udd_Gjc"], d["udd_Gir"])
        A = _csc_to_dense(p, n, d[f"udd_A{k}pr"], d["udd_Ajc"], d["udd_Air"])
        probs.append(make_problem(st, G, A, d[f"udd_c{k}"], d[f"udd_h{k}"],
                                  d[f"udd_b{k}"]))
    return st, probs[0], probs[1], d["udd_optval1"], d["udd_optval2"]


def make_mpc_like(horizon: int = 249, nx: int = 4, nu: int = 2, seed: int = 0,
                  rate_bound: float = 1.0):
    """Generate an MPC01-family LP: a box-constrained linear-dynamics
    trajectory problem in the same LP form/scale class as MPC02
    (n=1496, m=3996, p=499, l=3996, ncones=0 —
    EiCOS test/MPC/MPC02.h:4-8; MPC01 itself is a missing blob).

    Variables: states x_1..x_T (nx each) and inputs u_0..u_{T-1} (nu each),
    n = T*(nx+nu).  Equalities: dynamics x_{t+1} = F x_t + B u_t
    (p = T*nx).  Inequalities: box bounds on all variables (2n rows) plus
    two-sided input rate bounds |u_t - u_{t-1}| <= rate_bound for
    t = 1..T-1 (2*(T-1)*nu rows), so m = 2n + 2*(T-1)*nu.  With the
    benchmark's (horizon=249, nx=2, nu=4) this gives n=1494, p=498,
    m=4972 — at or above MPC02 on every axis (m is 24% larger than the
    family's 3996; the benchmark problem is strictly not lighter).
    """
    rng = np.random.default_rng(seed)
    T = horizon
    n = T * (nx + nu)
    # stable random dynamics
    F = rng.standard_normal((nx, nx))
    F *= 0.95 / max(1e-9, np.max(np.abs(np.linalg.eigvals(F))))
    Bm = rng.standard_normal((nx, nu))
    x0 = rng.standard_normal(nx)

    # variable layout: [x_1..x_T, u_0..u_{T-1}]
    def xidx(t):  # t in 1..T
        return slice((t - 1) * nx, t * nx)

    def uidx(t):  # t in 0..T-1
        return slice(T * nx + t * nu, T * nx + (t + 1) * nu)

    p = T * nx
    A = np.zeros((p, n))
    b = np.zeros(p)
    for t in range(T):
        rows = slice(t * nx, (t + 1) * nx)
        A[rows, xidx(t + 1)] = -np.eye(nx)
        A[rows, uidx(t)] = Bm
        if t == 0:
            b[rows] = -F @ x0
        else:
            A[rows, xidx(t)] = F
    # box constraints on everything: -bound <= v <= bound
    G_box = np.vstack([np.eye(n), -np.eye(n)])
    h_box = np.full(2 * n, 5.0)
    # input rate bounds: -r <= u_t - u_{t-1} <= r for t = 1..T-1
    n_rate = (T - 1) * nu
    R = np.zeros((n_rate, n))
    for t in range(1, T):
        rows = slice((t - 1) * nu, t * nu)
        R[rows, uidx(t)] = np.eye(nu)
        R[rows, uidx(t - 1)] = -np.eye(nu)
    G = np.vstack([G_box, R, -R])
    h = np.concatenate([h_box, np.full(2 * n_rate, rate_bound)])
    m = G.shape[0]
    c = rng.standard_normal(n) * 0.1
    st = ProblemStructure.create(n, p, m, m, ())
    return st, make_problem(st, G, A, c, h, b)


def make_mpc_soc(horizon: int = 249, nx: int = 2, nu: int = 4, seed: int = 0,
                 u_max: float = 1.0):
    """Generate an SOC-constrained MPC at MPC01-family scale: the same
    linear-dynamics trajectory problem as ``make_mpc_like`` but with the
    input bounds replaced by per-step Euclidean norm balls
    ||u_t||_2 <= u_max — one SOC of dimension nu+1 per step.

    The genuinely-conic benchmark lane the reference corpus lacks (its
    SOCPs — issue98, unboundedMaxSqrt — are tiny correctness checks).
    Dims at the default (249, 2, 4): n=1494, p=498, l=2988,
    q=(5,)*249, m=4233.
    """
    rng = np.random.default_rng(seed)
    T = horizon
    n = T * (nx + nu)
    F = rng.standard_normal((nx, nx))
    F *= 0.95 / max(1e-9, np.max(np.abs(np.linalg.eigvals(F))))
    Bm = rng.standard_normal((nx, nu))
    x0 = rng.standard_normal(nx)

    def xidx(t):  # t in 1..T
        return slice((t - 1) * nx, t * nx)

    def uidx(t):  # t in 0..T-1
        return slice(T * nx + t * nu, T * nx + (t + 1) * nu)

    p = T * nx
    A = np.zeros((p, n))
    b = np.zeros(p)
    for t in range(T):
        rows = slice(t * nx, (t + 1) * nx)
        A[rows, xidx(t + 1)] = -np.eye(nx)
        A[rows, uidx(t)] = Bm
        if t == 0:
            b[rows] = -F @ x0
        else:
            A[rows, xidx(t)] = F
    # LP rows: box bounds on ALL variables (keeps the problem bounded even
    # when the objective rewards large states)
    l = 2 * n
    G_lp = np.vstack([np.eye(n), -np.eye(n)])
    h_lp = np.full(l, 5.0)
    # SOC rows: per step, (u_max, u_t) in SOC(nu+1)  <=>  ||u_t|| <= u_max
    q = (nu + 1,) * T
    ms = T * (nu + 1)
    G_soc = np.zeros((ms, n))
    h_soc = np.zeros(ms)
    for t in range(T):
        r0 = t * (nu + 1)
        h_soc[r0] = u_max            # head: h - 0 = u_max
        G_soc[r0 + 1: r0 + nu + 1, uidx(t)] = -np.eye(nu)
    G = np.vstack([G_lp, G_soc])
    h = np.concatenate([h_lp, h_soc])
    m = G.shape[0]
    c = rng.standard_normal(n) * 0.1
    st = ProblemStructure.create(n, p, m, l, q)
    return st, make_problem(st, G, A, c, h, b)
