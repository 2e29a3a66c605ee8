"""Human-readable solver output: the port of ``eicos_tpu.utils.printing``
(the reference's verbose table and printSummary).  Printing is host-side,
from a returned ``Solution``: ``host_copy`` moves it off the device once,
after the solve, and the loop never syncs to print.  The live table
(``Settings(verbose_live=True)``, ``solve_live``) prints the same rows
during the solve, from the host loop (``solver.LiveTable``)."""

from __future__ import annotations

import sys

import numpy as np

from ..exitcodes import ExitCode

_HEADER = ("It     pcost       dcost      gap   pres   dres    k/t    mu"
           "     step   sigma     IR")


def host_copy(solution):
    """The solution (a NamedTuple of tensors, nested) as NumPy arrays."""
    if isinstance(solution, tuple):
        return type(solution)(*[host_copy(v) for v in solution])
    return solution.detach().cpu().numpy()


def format_iteration_row(i, pcost, dcost, gap, pres, dres, kapovert, mu,
                         step, sigma, n1, n2, n3) -> str:
    """One reference-style table row."""
    line = (f"{i:2d}  {pcost:+5.3e}  {dcost:+5.3e}  {gap:+2.0e}  "
            f"{pres:2.0e}  {dres:2.0e}  {kapovert:2.0e}  {mu:2.0e}")
    if i == 0:
        return f"{line}    ---    ---   {n1:2d}/{n2:2d}  -"
    return f"{line}  {step:6.4f}  {sigma:2.0e}  {n1:2d}/{n2:2d}/{n3:2d}"


def print_iteration_table(solution) -> None:
    """Reference-style per-iteration table, from the solution's history
    (one lane, on the host: ``host_copy``)."""
    h = solution.history
    n_it = int(solution.info.iter)
    print(_HEADER)
    for i in range(n_it + 1):
        print(format_iteration_row(
            i, float(h.pcost[i]), float(h.dcost[i]), float(h.gap[i]),
            float(h.pres[i]), float(h.dres[i]), float(h.kapovert[i]),
            float(h.mu[i]), float(h.step[i]), float(h.sigma[i]),
            int(h.nitref1[i]), int(h.nitref2[i]), int(h.nitref3[i])))


def print_summary(structure, solution, file=None) -> None:
    out = file if file is not None else sys.stdout
    info = solution.info
    code = ExitCode(int(np.asarray(solution.exit_code)))

    def p(line=""):
        print(line, file=out)

    p("- - - - - - - - - - - - - - -")
    p("|      Problem summary      |")
    p("- - - - - - - - - - - - - - -")
    p(f"    Primal variables:  {structure.n}")
    p(f"Equality constraints:  {structure.p}")
    p(f"     Conic variables:  {structure.m}")
    p(f"  Size of LP cone:     {structure.l}")
    p(f"  Number of SOCs:      {structure.n_sc}")
    p("- - - - - - - - - - - - - - -")
    p(f"exit:   {code.name} ({int(code)})")
    p(f"iters:  {int(info.iter)}")
    p(f"pcost:  {float(info.pcost):+.9e}")
    p(f"dcost:  {float(info.dcost):+.9e}")
    p(f"gap:    {float(info.gap):.3e}   pres: {float(info.pres):.3e}"
      f"   dres: {float(info.dres):.3e}")
    p(f"k/t:    {float(info.kapovert):.3e}   mu: {float(info.mu):.3e}")
