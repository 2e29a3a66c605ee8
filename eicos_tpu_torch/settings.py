"""Solver settings: a copy of ``eicos_tpu.settings.Settings``, knob for knob,
so that a configuration maps one to one between the two packages.

Defaults replicate EiCOS's ``Settings``.  The frozen dataclass is hashable;
the port uses that only to key its per-structure caches.

Knobs that do nothing under native float64 on the GPU (they select TPU
double-single machinery the port does not have, and are accepted so that a
configuration written for ``eicos_tpu`` runs unchanged):

  * ``pallas_leaf`` — the TPU leaf kernels; the port's band factor and
    dense leaf kernels always run their own f64 leaf;
  * ``band_gemm`` — float32 block products on the TPU's MXU; the port's
    block products are f64;
  * ``chunk_store`` — bf16/int8 chunk storage of the prechunked factor;
    the port stores the factor in f64.

``dense_solve`` picks the solve of the dense "reduced" strategy: "inverse"
and "auto" run the explicit-inverse path (``ops/ldl.ldl_solve``, two
passes over L^{-1}), as the JAX package does off the TPU; "subst" raises
``NotImplementedError`` until the substitution kernels (K15/K16) are
ported.  Once they are, "auto" on a CUDA tensor moves to them, as it does
on the TPU.  The rescue pass pins "auto" to "inverse"
(``api._rescue_settings``).

``kkt_strategy`` "full" and "normal" and ``factor_dtype="float32"`` raise
``NotImplementedError`` in the port until their slice lands.
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
    verbose_live: bool = False   # live iteration table (not ported yet)
    pallas_leaf: str = "auto"    # no-op under native f64 (module doc)
    band_gemm: str = "float64"   # no-op under native f64
    chunk_store: str = "bf16"    # no-op under native f64
    dense_solve: str = "auto"    # "reduced" solve path (module doc)

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
