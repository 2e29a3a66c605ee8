"""ECOS-compatible API shim: the port of ``eicos_tpu.ecos_compat``.

EiCOS ships an ECOS C-API adapter so that unmodified ECOS test programs
run against it (its ``test/ecos.h:7-44``).  This is the same adapter for
Python callers: ``ecos_setup`` / ``ecos_solve`` / ``ecos_update_data`` /
``ecos_cleanup`` with the classic exit-code macros, and ``solve_ecos``, the
``ecos.solve``-style entry that takes scipy.sparse matrices and a
cvxpy-style dims dict.  Each builds a ``Solver``, so it runs on CUDA unless
the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np

from .api import Solver
from .settings import Settings

# classic ECOS exit-code macros (EiCOS test/ecos.h:36-44)
ECOS_OPTIMAL = 0
ECOS_PINF = 1
ECOS_DINF = 2
ECOS_INACC_OFFSET = 10
ECOS_MAXIT = -1
ECOS_NUMERICS = -2
ECOS_OUTCONE = -3
ECOS_SIGINT = -4
ECOS_FATAL = -7


def ecos_setup(n, m, p, l, ncones, q, nexc,
               Gpr, Gjc, Gir, Apr, Ajc, Air, c, h, b,
               settings: Settings = Settings(), device=None):
    """ECOS_setup(...).  ``nexc`` (exponential cones) is accepted and
    ignored, as the reference shim does: EiCOS has no exponential cones."""
    del nexc
    return Solver.from_csc(n=n, m=m, p=p, l=l, ncones=ncones, q=q,
                           Gpr=Gpr, Gjc=Gjc, Gir=Gir,
                           Apr=Apr, Ajc=Ajc, Air=Air,
                           c=c, h=h, b=b, settings=settings, device=device)


def ecos_solve(work: Solver) -> int:
    return int(work.solve())


def ecos_update_data(work: Solver, Gpr=None, Apr=None, c=None, h=None,
                     b=None):
    """ECOS_updateData: new values on the same sparsity pattern.  Raw value
    arrays are mapped back through the stored CSC pattern; new G values
    come with h and new A values with b, as in the reference."""
    import scipy.sparse as sp

    kw = {}
    if Gpr is not None:
        pat = sp.csc_matrix(np.asarray(work._data.G))
        pat.data = np.asarray(Gpr, dtype=np.float64)
        kw["G"] = pat.toarray()
        kw["h"] = h
    if Apr is not None:
        pat = sp.csc_matrix(np.asarray(work._data.A))
        pat.data = np.asarray(Apr, dtype=np.float64)
        kw["A"] = pat.toarray()
        kw["b"] = b
    if c is not None:
        kw["c"] = c
    work.update_data(**kw)


def ecos_cleanup(work: Solver, flags: int = 0) -> None:
    del work, flags  # garbage collected; nothing to free explicitly


def solve_ecos(c, G=None, h=None, dims=None, A=None, b=None,
               settings: Settings = Settings(), device=None):
    """python-ecos style entry, dims = {"l": int, "q": [int, ...]}.
    Returns a dict with x, y, z, s (NumPy), info and exitFlag."""
    dims = dims or {}
    q = tuple(dims.get("q", ()) or ())
    solver = Solver(G, A, c, h, b, soc_dims=q, settings=settings,
                    device=device)
    code = solver.solve()
    sol = solver.last_solution
    return {
        "x": sol.x.cpu().numpy(),
        "y": sol.y.cpu().numpy(),
        "z": sol.z.cpu().numpy(),
        "s": sol.s.cpu().numpy(),
        "info": sol.info,
        "exitFlag": int(code),
    }


__all__ = [
    "ecos_setup", "ecos_solve", "ecos_update_data", "ecos_cleanup",
    "solve_ecos",
    "ECOS_OPTIMAL", "ECOS_PINF", "ECOS_DINF", "ECOS_INACC_OFFSET",
    "ECOS_MAXIT", "ECOS_NUMERICS", "ECOS_OUTCONE", "ECOS_SIGINT",
    "ECOS_FATAL",
]
