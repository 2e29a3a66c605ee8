"""eicos_tpu_torch — the PyTorch/CUDA port of eicos_tpu, a second-order
cone program solver, for NVIDIA Hopper.

Solves
    minimize    c'x
    subject to  Ax = b
                Gx + s = h,  s in K = R^l_+ x SOC(q_1) x ... x SOC(q_N)

with the Mehrotra predictor-corrector interior-point method on the
homogeneous self-dual embedding, lane-batched, in IEEE float64.  The
"banded" KKT strategy's band LDL^T factor and solves, and the dense
"reduced" strategy's leaf LDL^T, GEMM and inverse solves (the rescue
pass's path), run in hand-written CUDA kernels (``csrc/``), built with
nvcc at first use; every kernel has a plain torch version that runs for
CPU tensors.

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
]
