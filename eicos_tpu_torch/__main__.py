"""Command-line interface: the port of ``eicos_tpu.__main__``, the
analogue of the reference's executables (the ``eicos_test_problem`` demo,
its ``src/run.cpp``, and the ``eicos_run_tests`` corpus runner, its
``test/ecostester.cpp``).

    python -m eicos_tpu_torch solve problem.npz [--verbose | --live]
                                 [--strategy banded] [--device cuda]
    python -m eicos_tpu_torch demo [--horizon 40] [--batch 8]
    python -m eicos_tpu_torch corpus [--problems lp_afiro,feas] [--all]

Every subcommand solves on ``--device``, CUDA by default (without a CUDA
device it raises, as the entry points do); ``--device cpu`` runs the plain
torch path.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def _settings(args):
    from .settings import Settings

    kw = {}
    if getattr(args, "strategy", None):
        kw["kkt_strategy"] = args.strategy
    if getattr(args, "factor_dtype", None):
        kw["factor_dtype"] = args.factor_dtype
    return Settings(**kw)


def _device(args):
    """``None`` (CUDA, which must exist: ``solver.resolve_device``) for
    "cuda", else the device named."""
    return None if args.device == "cuda" else args.device


def _attach_plan(args, st, prob):
    if getattr(args, "strategy", None) == "banded":
        from .plan import make_band_plan

        return st.with_band_plan(make_band_plan(st, prob.G, prob.A))
    return st


def cmd_solve(args) -> int:
    from .io import load_problem
    from .solver import solve, solve_live
    from .utils.printing import (host_copy, print_iteration_table,
                                 print_summary)
    from .utils.timing import tic, toc

    st, prob = load_problem(args.problem)
    st = _attach_plan(args, st, prob)
    t0 = tic()
    if args.live:
        sol = solve_live(st, prob, _settings(args), device=_device(args))
    else:
        sol = solve(st, prob, _settings(args), device=_device(args))
    sol = host_copy(sol)
    dt = toc(t0)
    if args.verbose and not args.live:
        print_iteration_table(sol)
    print_summary(st, sol)
    print(f"wall:   {dt:.1f} ms (incl. kernel build)")
    return 0 if int(sol.exit_code) in (0, 1, 2, 10, 11, 12) else 1


def cmd_demo(args) -> int:
    """Setup, solve, ``update_data`` and re-solve, and with ``--batch`` a
    batch: the steps of the reference demo (its ``src/run.cpp:7-53``) on an
    MPC01-family problem, as ``examples/run_demo.py`` runs them for the
    JAX package."""
    from . import corpus
    from .api import BatchedSolver, Solver
    from .exitcodes import ExitCode
    from .problem import ProblemData
    from .utils.timing import tic, timed, toc

    ok = (ExitCode.OPTIMAL, ExitCode.CLOSE_TO_OPTIMAL)
    dev = _device(args)
    t0 = tic()
    st, prob = corpus.make_mpc_like(horizon=args.horizon)
    solver = Solver(prob.G, prob.A, prob.c, prob.h, prob.b, device=dev)
    print(f"Setup time: {toc(t0):.1f} ms (n={st.n}, m={st.m}, p={st.p})")

    code, ms = timed(solver.solve)
    print(f"First solve time (incl. kernel build): {ms:.1f} ms -> "
          f"{code.name}, {int(solver.get_info().iter)} iters")
    if code not in ok:
        return 1

    rng = np.random.default_rng(1)
    t0 = tic()
    solver.update_data(c=np.asarray(prob.c)
                       + 0.05 * rng.standard_normal(st.n))
    print(f"Data update time: {toc(t0):.1f} ms")
    code, ms = timed(solver.solve)
    print(f"Second solve time (cached program): {ms:.1f} ms -> "
          f"{code.name}, {int(solver.get_info().iter)} iters")
    if code not in ok:
        return 1

    if args.batch:
        probs = [ProblemData(G=prob.G, A=prob.A,
                             c=np.asarray(prob.c)
                             + 0.05 * rng.standard_normal(st.n),
                             h=prob.h, b=prob.b)
                 for _ in range(args.batch)]
        batch = BatchedSolver.stack(probs)
        bs = BatchedSolver(st, device=dev)
        timed(bs.solve, batch)              # the first solve of the batch
        sols, ms = timed(bs.solve, batch)
        codes = sols.exit_code.cpu().numpy()
        print(f"Batch of {args.batch}: {ms:.1f} ms "
              f"({args.batch / (ms / 1e3):.1f} solves/s), "
              f"{int(np.sum(codes == 0))} optimal")
    return 0


def cmd_corpus(args) -> int:
    """Run the reference corpus: the eicos_run_tests analogue."""
    from . import corpus
    from .solver import solve

    if not os.path.isdir(corpus.REFERENCE_TEST_DIR):
        print(f"corpus: no reference test headers at "
              f"{corpus.REFERENCE_TEST_DIR} (set EICOS_REFERENCE_TESTS)",
              file=sys.stderr)
        return 2
    names = (args.problems.split(",") if args.problems
             else [e.name for e in corpus.CORPUS
                   if e.name not in ("MPC02", "lp_bnl1", "lp_25fv47")
                   or args.all])
    n_pass = 0
    t_start = time.time()
    for name in names:
        st, prob, expected = corpus.load(name)
        st = _attach_plan(args, st, prob)
        t0 = time.time()
        sol = solve(st, prob, _settings(args), device=_device(args))
        code = int(sol.exit_code)
        ok = code in [int(e) for e in expected]
        n_pass += ok
        print(f"{'PASS' if ok else 'FAIL'}  {name:18s} exit={code:3d} "
              f"iters={int(sol.info.iter):3d}  {time.time() - t0:6.1f}s")
    print(f"\n{n_pass}/{len(names)} passed "
          f"({time.time() - t_start:.1f}s total)")
    return 0 if n_pass == len(names) else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="eicos_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def device_arg(p):
        p.add_argument("--device", default="cuda",
                       help="cuda (the default) or cpu (plain torch path)")

    p = sub.add_parser("solve", help="solve a problem saved as .npz")
    p.add_argument("problem")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--live", action="store_true",
                   help="stream the iteration table during the solve")
    p.add_argument("--strategy", choices=("full", "reduced", "banded"))
    p.add_argument("--factor-dtype", choices=("float64", "float32"))
    device_arg(p)
    p.set_defaults(fn=cmd_solve)

    p = sub.add_parser("demo", help="setup/solve/update/re-solve demo")
    p.add_argument("--horizon", type=int, default=40)
    p.add_argument("--batch", type=int, default=0)
    device_arg(p)
    p.set_defaults(fn=cmd_demo)

    p = sub.add_parser("corpus", help="run the reference test corpus")
    p.add_argument("--problems", default="")
    p.add_argument("--all", action="store_true",
                   help="include the largest problems")
    p.add_argument("--strategy", choices=("full", "reduced", "banded"))
    p.add_argument("--factor-dtype", choices=("float64", "float32"))
    device_arg(p)
    p.set_defaults(fn=cmd_corpus)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
