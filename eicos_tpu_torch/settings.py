"""Solver settings: a copy of ``eicos_tpu.settings.Settings``, knob for knob,
so that a configuration maps one to one between the two packages.

Defaults replicate EiCOS's ``Settings``.  The frozen dataclass is hashable;
the port uses that only to key its per-structure caches.

Knobs that do nothing under native float64 on the GPU (they select TPU
double-single machinery the port does not have, and are accepted so that a
configuration written for ``eicos_tpu`` runs unchanged):

  * ``pallas_leaf`` — the TPU leaf kernels; the port's band factor, scan
    and dense leaves always run its own leaf kernels on the card;
  * ``chunk_store`` — bf16/int8 chunk storage of the prechunked factor;
    the port stores the factor in f64.

``band_gemm="float32"`` runs the block products of the banded scan
(``ops/band_ldl.band_ldl_factor`` / ``band_ldl_solve``: block bandwidth
above 6, or an f32 factor) in float32, as the reference does on its scan
path and nowhere else; the band kernels at block bandwidths 1..6 compute
in f64 whatever it says.  The products are ``torch.matmul`` with TF32 off
(``torch.backends.cuda.matmul.allow_tf32`` False, torch's default, which
the card suite checks), the reference's "highest" precision.

``kkt_strategy``: all four run.  "full" (the default) factors the dense K
over [z | x | y]; "reduced" eliminates the LP rows and keeps the SOC rows;
"normal" eliminates every cone row; "banded" factors the RCM-permuted band
(the band kernels at block bandwidths 1..6, the scan above).

``dense_solve`` picks the solve of the dense strategies: "inverse" is the
explicit-inverse path (``ops/ldl.ldl_factor``, two passes over L^{-1}),
"subst" the substitution form (``ops/ldl.ldl_factor_subst``, the packed
blocks of L and the two sweeps of ``ops/dense.py``).  "auto" follows the
device the solve runs on, as every dispatch of the port does: on CUDA
"reduced" and "normal" take "subst" (as on the TPU) and "full" stays on
"inverse" (as in the reference); on the CPU all three take "inverse" (as
the JAX package does there).  "subst" on the CPU runs the plain versions
of the pack and the sweeps.  The rescue pass pins "auto" to "inverse"
(``api._rescue_settings``).

``factor_dtype="float32"`` factors and solves in f32 (the f32 leaf kernel,
``torch.matmul`` products; the dense strategies on the inverse path,
"banded" on the scan) under the f64 refinement.  ``deltastat`` is below
f32's epsilon, so such a solve may end short of OPTIMAL where f64 does
not, as in the JAX package.  ``block`` is the LDL^T block size of every
strategy (under "banded" the plan's); off 128 the leaves are the plain
leaf on every device, "banded" runs the scan and the dense strategies the
inverse path, as in the JAX package, which reaches no Pallas leaf there.

``verbose_live=True`` prints the reference's iteration table during the
solve, lane 0's row as each iteration ends (``solver.LiveTable``).
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class Settings:
    gamma: float = 0.99          # scaling of the final step length
    delta: float = 2e-7          # (unused in reference; kept for parity)
    deltastat: float = 7e-8      # static regularization
    eps: float = 1e13            # regularization threshold (unused in ref)
    feastol: float = 1e-8        # primal/dual infeasibility tolerance
    abstol: float = 1e-8         # absolute tolerance on duality gap
    reltol: float = 1e-8         # relative tolerance on duality gap
    feastol_inacc: float = 1e-4  # relaxed infeasibility tolerance
    abstol_inacc: float = 5e-5   # relaxed absolute gap tolerance
    reltol_inacc: float = 5e-5   # relaxed relative gap tolerance
    nitref: int = 9              # max iterative refinement steps
    maxit: int = 100             # (alias of iter_max in reference)
    linsysacc: float = 1e-14     # relative accuracy of search direction
    irerrfact: float = 6.0       # required IR error reduction factor
    stepmin: float = 1e-6        # smallest admissible step
    stepmax: float = 0.999       # largest admissible step
    sigmamin: float = 1e-4       # always do some centering
    sigmamax: float = 1.0        # never fully center
    equil_iters: int = 3         # equilibration iterations
    iter_max: int = 100          # maximum IPM iterations
    safeguard: float = 500.0     # max PRES increase before NUMERICS

    kkt_strategy: str = "full"   # "full" | "reduced" | "normal" | "banded"
    factor_dtype: str = "float64"  # "float64" | "float32"
    block: int = 128             # LDL^T block size
    verbose_live: bool = False   # stream lane 0's table rows (module doc)
    pallas_leaf: str = "auto"    # no-op under native f64 (module doc)
    band_gemm: str = "float64"   # the banded scan's products (module doc)
    chunk_store: str = "bf16"    # no-op under native f64
    dense_solve: str = "auto"    # dense strategies' solve path (module doc)

    def __post_init__(self):
        _check = {
            "kkt_strategy": ("full", "reduced", "normal", "banded"),
            "factor_dtype": ("float64", "float32"),
            "pallas_leaf": ("auto", "on", "off"),
            "band_gemm": ("float64", "float32"),
            "chunk_store": ("bf16", "i8"),
            "dense_solve": ("auto", "subst", "inverse"),
        }
        for field, allowed in _check.items():
            value = getattr(self, field)
            if value not in allowed:
                raise ValueError(
                    f"Settings.{field}={value!r} is not one of {allowed}")
