"""eicos_tpu_torch — the PyTorch/CUDA port of eicos_tpu, a second-order
cone program solver, for NVIDIA Hopper.

Solves
    minimize    c'x
    subject to  Ax = b
                Gx + s = h,  s in K = R^l_+ x SOC(q_1) x ... x SOC(q_N)

with the Mehrotra predictor-corrector interior-point method on the
homogeneous self-dual embedding, lane-batched, in IEEE float64.  All four
KKT strategies of the reference run on the card: "banded" (the band LDL^T
factor and sweeps at block bandwidths 1..6, the scan of batched products
and the leaf kernel above 6 and in f32), "reduced", "normal" and "full"
(the dense recursion's blocked leaf LDL^T, DMMA GEMM, and the inverse or
substitution solves), the rescue pass, ``factor_dtype="float32"`` and
any ``Settings.block``.  The residual and elimination products run as the
reference's TPU path runs them: a gather kernel on the narrow patterns
(``ops/spmv.py``), the GEMM kernel on the wide ones, and a rotated
refinement loop.  ``BatchedSolver(mesh=)`` splits the lanes over several
cards (``parallel/sharding.py``).  Every TPU kernel of the reference has a
hand-written CUDA kernel here (``csrc/``, built with nvcc at first use),
and every kernel has a plain torch version that runs for CPU tensors.  The iteration table prints
during a solve (``solver.solve_live``, ``Solver.solve_live``,
``Settings(verbose_live=True)``) or after it
(``Solver.solve(verbose=True)``); ``save_problem``/``load_problem`` read
and write the reference's npz files, ``corpus`` loads its test headers,
``ecos_compat`` is its ECOS shim and ``python -m eicos_tpu_torch`` its
command line.

Entry points run on CUDA unless the caller passes ``device="cpu"``.  The
package imports torch, numpy and scipy, and nothing of JAX or
``eicos_tpu``.
"""

from .exitcodes import ExitCode
from .settings import Settings
from .structure import ConeStructure, ProblemStructure
from .problem import ProblemData
from .solver import solve, Solution
from .api import Solver, BatchedSolver
from .io import save_problem, load_problem

__version__ = "0.1.0"

__all__ = [
    "ExitCode",
    "Settings",
    "ConeStructure",
    "ProblemStructure",
    "ProblemData",
    "solve",
    "Solution",
    "Solver",
    "BatchedSolver",
    "save_problem",
    "load_problem",
]
