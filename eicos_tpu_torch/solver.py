"""The interior-point loop: Mehrotra predictor-corrector on the
homogeneous self-dual embedding, batched over lanes: a port of
``eicos_tpu.solver`` (EiCOS Solver::solve with computeResiduals,
updateStatistics, checkExitConditions, isBetterThan, RHSaffine,
RHScombined and backscale).

``lax.while_loop`` under ``vmap`` becomes a loop over a batched state with
a leading lane axis.  Every lane runs the same arithmetic; a lane that has
exited keeps its state unchanged from then on, as a lane of the JAX
package's vmapped loop does.  The whole solve runs as the segments of a
``graphs.Program``: the prologue (equilibration, the KKT context, the init
factor and the start of the init systems' solve), their refinement trip,
the loop state's init, then a loop body of part A (statistics, history,
exit logic, scalings, the factor, the predictor solve's start), the
refinement trip at two right-hand sides, part B (the affine step and the
combined right-hand side's solve start), the trip at one, and part C (the
step and the new state, written into the loop's state buffers in place),
and the finish.  On a CUDA tensor each segment is captured once as a CUDA
graph, at its first call, and replayed from then on: by every later call
of the solve and, where the caller keeps the program (``program_for``;
``api.Solver`` and ``api.BatchedSolver`` keep theirs), by every later
solve of the same key, the counterpart of the JAX package's compiled
solve and its cached executable.  On a CPU tensor they are plain calls.
The loops are written once (``_steps``): driven from the host, which
reads one flag back from the device per iteration ("all lanes done") and
one per refinement trip (``kkt.host_syncs`` counts them), or, for a kept
program after its first solve, composed into one graph whose conditional
WHILE nodes test the same flags on the card (``graphs.Program.compose``):
one launch and no host read a solve, as the JAX package's single
``lax.while_loop``.  A live table (``LiveTable``: ``solve_live``,
``Settings(verbose_live=True)``) drives the loop from the host and adds
one host copy of lane 0's history per group of rows it prints; the
module-level ``solve`` keeps no program and is host-driven too.

Semantics kept exactly from the reference (they decide exit codes):
updateScalings' out-of-cone flag is ignored (NaNs flow into the NaN exit);
pinfres/dinfres are sticky once set; the NaN exit at iteration 0 (or with a
better-than-best iterate) returns NOT_CONVERGED_YET; an unset relgap or
pinfres compares as C++ ``optional`` does (nullopt < x is true).
"""

from __future__ import annotations

import sys
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import cones, graphs, kkt
from .equilibrate import Equilibration, equilibrate
from .exitcodes import ExitCode
from .problem import ProblemData
from .settings import Settings
from .structure import ProblemStructure
from .utils import timing
from .utils.printing import _HEADER, format_iteration_row

_OPT = int(ExitCode.OPTIMAL)
_PINF = int(ExitCode.PRIMAL_INFEASIBLE)
_DINF = int(ExitCode.DUAL_INFEASIBLE)
_MAXIT = int(ExitCode.MAXIT)
_NUMERICS = int(ExitCode.NUMERICS)
_NOTCONV = int(ExitCode.NOT_CONVERGED_YET)
_INACC = 10


class Iterate(NamedTuple):
    """One iterate and its statistics; every field has a leading lane axis."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    s: torch.Tensor
    kap: torch.Tensor
    tau: torch.Tensor
    cx: torch.Tensor
    by: torch.Tensor
    hz: torch.Tensor
    pcost: torch.Tensor
    dcost: torch.Tensor
    gap: torch.Tensor
    relgap: torch.Tensor
    has_relgap: torch.Tensor
    pres: torch.Tensor
    dres: torch.Tensor
    pinfres: torch.Tensor
    has_pinfres: torch.Tensor
    dinfres: torch.Tensor
    has_dinfres: torch.Tensor
    mu: torch.Tensor
    kapovert: torch.Tensor
    sigma: torch.Tensor
    step: torch.Tensor
    step_aff: torch.Tensor
    iter: torch.Tensor
    nitref1: torch.Tensor
    nitref2: torch.Tensor
    nitref3: torch.Tensor


class History(NamedTuple):
    """Per-iteration statistics, (L, iter_max+1): the reference's verbose
    table, returned instead of printed."""

    pcost: torch.Tensor
    dcost: torch.Tensor
    gap: torch.Tensor
    pres: torch.Tensor
    dres: torch.Tensor
    kapovert: torch.Tensor
    mu: torch.Tensor
    step: torch.Tensor
    sigma: torch.Tensor
    nitref1: torch.Tensor
    nitref2: torch.Tensor
    nitref3: torch.Tensor


class LoopState(NamedTuple):
    it: Iterate
    best: Iterate
    rhs1: torch.Tensor
    pres_prev: torch.Tensor
    iter: torch.Tensor
    code: torch.Tensor
    done: torch.Tensor
    hist: History


class _PartA(NamedTuple):
    """What part A of an iteration gives B and C."""

    w: Iterate                 # the iterate with its statistics
    rx: torch.Tensor
    ry: torch.Tensor
    rz: torch.Tensor
    rt: torch.Tensor
    hist: History
    code: torch.Tensor         # the exit code of lanes exiting now
    exit_now: torch.Tensor
    final_it: Iterate          # the iterate an exiting lane returns
    best: Iterate
    stepping: torch.Tensor     # lanes that take a step
    scal: cones.Scaling
    lam: torch.Tensor
    solve: object              # kkt.ExactSolve
    rhs: torch.Tensor          # (L, 2, n+p+m) the predictor's right-hand sides
    ref: kkt.RefineState


class _PartB(NamedTuple):
    """What part B of an iteration gives C."""

    dtau_denom: torch.Tensor
    dtauaff: torch.Tensor
    dkapaff: torch.Tensor
    sigma: torch.Tensor
    sigmamu: torch.Tensor
    step_aff: torch.Tensor
    lam_ds: torch.Tensor
    rhs: torch.Tensor          # (L, 1, n+p+m) the combined right-hand side
    ref: kkt.RefineState


class Solution(NamedTuple):
    exit_code: torch.Tensor  # int32, ExitCode values
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    s: torch.Tensor
    info: Iterate            # final iterate incl. statistics (pre-backscale)
    pinf: torch.Tensor
    dinf: torch.Tensor
    history: History


def _norm(v):
    return torch.sqrt((v * v).sum(-1))


def _dot(a, b):
    return (a * b).sum(-1)


def _vm(v, M):
    """Row vectors times a shared (a, b) or per-lane (L, a, b) matrix:
    v (L, a) -> (L, b)."""
    if M.dim() == 2:
        return v @ M
    return (v[:, None, :] @ M)[:, 0]


def _where(pred, a, b):
    """Lane-wise select over (nested) NamedTuples of tensors."""
    if isinstance(a, tuple):
        return type(a)(*[_where(pred, u, v) for u, v in zip(a, b)])
    return torch.where(pred.view(-1, *([1] * (a.dim() - 1))), a, b)


def _check_exit(w: Iterate, feastol, abstol, reltol, reduced: bool):
    """checkExitConditions: an int32 code per lane (NOT_CONVERGED_YET if
    no test fires)."""
    relgap_eff = torch.where(w.has_relgap, w.relgap, -torch.inf)
    optimal = (((-w.cx > 0.0) | (-w.by - w.hz >= -abstol))
               & (w.pres < feastol) & (w.dres < feastol)
               & ((w.gap < abstol) | (relgap_eff < reltol)))
    dinf = w.has_dinfres & (w.dinfres < feastol) & (w.tau < w.kap)
    pinf_small = torch.where(w.has_pinfres, w.pinfres < feastol, True)
    pinf = ((w.has_pinfres & (w.pinfres < feastol) & (w.tau < w.kap))
            | ((w.tau < feastol) & (w.kap < feastol) & pinf_small))
    off = _INACC if reduced else 0
    code = torch.where(optimal, _OPT + off,
                       torch.where(dinf, _DINF + off,
                                   torch.where(pinf, _PINF + off, _NOTCONV)))
    return code.to(torch.int32)


def _is_better(i: Iterate, o: Iterate):
    """Information::isBetterThan (it compares this->pinfres against
    other.pres)."""
    gap_improves = (i.gap > 0.0) & (o.gap > 0.0) & (i.gap < o.gap)
    mu_improves = (i.mu > 0.0) & (i.mu < o.mu)
    infeas_case = i.has_pinfres & (i.kapovert > 1.0)
    sub = torch.where(
        o.has_pinfres,
        gap_improves & (i.pinfres > 0.0) & (i.pinfres < o.pres) & mu_improves,
        gap_improves & mu_improves)
    regular = (gap_improves
               & (i.pres > 0.0) & (i.pres < o.pres)
               & (i.dres > 0.0) & (i.dres < o.dres)
               & (i.kapovert > 0.0) & (i.kapovert < o.kapovert)
               & mu_improves)
    return torch.where(infeas_case, sub, regular)


def _statistics(st, settings, w: Iterate, ctx, c, h, b, res0s):
    """computeResiduals + updateStatistics at iterate ``w``: returns the
    residuals (rx, ry, rz), rt and ``w`` with its statistics filled in.
    The products take the context's operands where it has them (two fused
    products over [G; A] and [A' | G'] where A has rows, as the JAX
    package's TPU path does, each with its negation or its + s in the
    same call), else the dense equilibrated G and A."""
    n, p, m = st.n, st.p, st.m
    G, A = ctx.G, ctx.A
    lanes = w.x.shape[0]
    resx0, resy0, resz0 = res0s
    zero = w.x.new_zeros(lanes)
    if p and ctx.sGA is not None:
        rx_h = ctx.sGA.rmatmul_fused(w.z, w.y, op="sub")
        ryz = ctx.sAGT.rmatmul_fused(w.x, base=(None, w.s), split=p)
        ry_h = ryz[:, :p]
        rz_h = ryz[:, p:]
    elif ctx.sG is not None:
        rx_h = ctx.sG.rmatmul_fused(w.z, op="sub")
        ry_h = w.x.new_zeros(lanes, 0)
        rz_h = ctx.sGT.rmatmul_fused(w.x, base=w.s)
    else:
        rx_h = -_vm(w.z, G)
        if p:
            rx_h = rx_h - _vm(w.y, A)
        ry_h = (_vm(w.x, A.transpose(-1, -2)) if p
                else w.x.new_zeros(lanes, 0))
        rz_h = w.s + _vm(w.x, G.transpose(-1, -2))
    hresx = _norm(rx_h)
    rx = rx_h - w.tau[:, None] * c
    hresy = _norm(ry_h)
    ry = ry_h - w.tau[:, None] * b
    hresz = _norm(rz_h)
    rz = rz_h - w.tau[:, None] * h

    cx = _dot(c, w.x) if n else zero
    by = _dot(b, w.y) if p else zero
    hz = _dot(h, w.z) if m else zero
    rt = w.kap + cx + by + hz
    nx, ny = _norm(w.x), _norm(w.y)
    nz, ns = _norm(w.z), _norm(w.s)

    gap = _dot(w.s, w.z) if m else zero
    mu = (gap + w.kap * w.tau) / (st.degrees + 1)
    kapovert = w.kap / w.tau
    pcost = cx / w.tau
    dcost = -(hz + by) / w.tau
    has_relgap = (pcost < 0.0) | (dcost > 0.0)
    relgap = torch.where(pcost < 0.0, gap / -pcost,
                         torch.where(dcost > 0.0, gap / dcost, torch.nan))
    nry = (_norm(ry) / torch.clamp(resy0 + nx, min=1.0)) if p else zero
    nrz = _norm(rz) / torch.clamp(resz0 + nx + ns, min=1.0)
    pres = torch.maximum(nry, nrz) / w.tau
    dres = _norm(rx) / torch.clamp(resx0 + ny + nz, min=1.0) / w.tau
    set_pinf = (hz + by) / torch.clamp(ny + nz, min=1.0) < -settings.reltol
    pinfres = torch.where(set_pinf, hresx / torch.clamp(ny + nz, min=1.0),
                          w.pinfres)
    set_dinf = cx / torch.clamp(nx, min=1.0) < -settings.reltol
    dinfres = torch.where(
        set_dinf,
        torch.maximum(hresy / torch.clamp(nx, min=1.0),
                      hresz / torch.clamp(nx + ns, min=1.0)),
        w.dinfres)
    w = w._replace(
        cx=cx, by=by, hz=hz, pcost=pcost, dcost=dcost, gap=gap,
        relgap=relgap, has_relgap=has_relgap, pres=pres, dres=dres,
        pinfres=pinfres, has_pinfres=w.has_pinfres | set_pinf,
        dinfres=dinfres, has_dinfres=w.has_dinfres | set_dinf,
        mu=mu, kapovert=kapovert)
    return (rx, ry, rz), rt, w


def _checks(settings):
    def full(w):
        return _check_exit(w, settings.feastol, settings.abstol,
                           settings.reltol, reduced=False)

    def red(w):
        return _check_exit(w, settings.feastol_inacc, settings.abstol_inacc,
                           settings.reltol_inacc, reduced=True)

    return full, red


class LiveTable:
    """The reference's iteration table printed during a solve, from the
    host loop: lane 0's rows, each once, in groups of ``seg`` loop
    trips, from one host copy of that lane's history a group, as
    ``eicos_tpu.solver.solve_live`` prints the rows that became final
    between its segments.  ``file=None`` prints to ``sys.stdout``.  It
    only reads the state: a solve with a table returns the same bits as
    one without."""

    def __init__(self, seg: int = 1, file=None):
        if seg < 1:
            raise ValueError(f"seg must be >= 1, got {seg}")
        self.seg, self.file = seg, file
        self.printed = 0        # rows printed so far
        self.trips = 0
        self.finished = False   # the lane's last row is out
        self._print(_HEADER)

    def _print(self, line: str) -> None:
        print(line, file=self.file if self.file is not None else sys.stdout,
              flush=True)

    def trip(self, state: "LoopState", last: bool = False) -> None:
        """After a loop trip: print the rows that became final, every
        ``seg`` trips and on the ``last`` one."""
        self.trips += 1
        if self.finished or (self.trips % self.seg and not last):
            return
        host = torch.cat([torch.stack([f[0].double() for f in state.hist]
                                      ).reshape(-1),
                          torch.stack([state.iter[0].double(),
                                       state.done[0].double()])]).cpu()
        itv, done = int(host[-2]), bool(host[-1])
        rows = host[:-2].reshape(len(state.hist), -1).tolist()
        end = itv if done else itv - 1
        for i in range(self.printed, end + 1):
            self._print(format_iteration_row(
                i, *[r[i] for r in rows[:9]], *[int(r[i]) for r in rows[9:]]))
        self.printed = max(self.printed, end + 1)
        self.finished = done


class _Prologue(NamedTuple):
    """What the prologue gives the rest of a solve."""

    eq: Equilibration
    res0s: tuple               # the residual norms' floors of c, b, h
    ctx: kkt.KKTContext
    init: kkt.ExactSolve       # the factor at identity scalings
    rhs: torch.Tensor          # (L, 2, n+p+m) the two init systems
    ref: kkt.RefineState       # their refined solve, between trips


class _Parts(NamedTuple):
    """A program's segments, in the order a solve calls them, and the
    function that gives the loop state's first value (the state buffers
    are made from it once)."""

    prologue: graphs.Segment
    init_trip: graphs.Segment
    init_state: graphs.Segment
    a: graphs.Segment
    trip2: graphs.Segment
    b: graphs.Segment
    trip1: graphs.Segment
    c: graphs.Segment
    finish: graphs.Segment
    first_state: object


def program_key(structure: ProblemStructure, data: ProblemData,
                settings: Settings) -> tuple:
    """What a program is built for: the structure, the settings, and each
    input's shape (its lanes, and which of G and A carry a lane axis),
    dtype and device."""
    return (structure, settings) + tuple(
        (tuple(t.shape), t.dtype, t.device) for t in _fields(data))


def _fields(data: ProblemData) -> tuple:
    return data.G, data.A, data.c, data.h, data.b


def program_for(program: Optional[graphs.Program],
                structure: ProblemStructure, data: ProblemData,
                settings: Settings, owner=None) -> graphs.Program:
    """``program`` where it was built for this solve's key; else it is
    closed first (its device memory released) and a new program, closed
    when ``owner`` is collected, takes its place."""
    key = program_key(structure, data, settings)
    if program is not None:
        if program.key == key:
            return program
        program.close()
    return graphs.Program(data.c.device, key, owner)


def _parts(program: graphs.Program, st: ProblemStructure,
           settings: Settings, lanes: int, dtype, device) -> _Parts:
    """The segments of a solve, made once a program.  Their functions
    close over the key's values and the structure's constants only:
    everything that depends on the problem's values comes in as an
    argument, so that a segment called (on a CPU tensor) or replayed
    (on a CUDA one) by a later solve reads that solve's values."""
    n, p, m = st.n, st.p, st.m
    cone = st.cone
    gamma = settings.gamma
    full_check, red_check = _checks(settings)
    nh = settings.iter_max + 1

    def zeros(*shape, dtype=dtype):
        return torch.zeros(*shape, dtype=dtype, device=device)

    def fill(v, dtype=dtype):
        return torch.full((lanes,), v, dtype=dtype, device=device)

    # the structure's constants, made outside every capture and held
    consts = cones._consts(cone, str(device))
    e_vec = zeros(m)
    e_vec[:st.l] = 1.0
    if st.n_sc:
        e_vec[st.l + consts.head_offsets] = 1.0
    sel_rows = torch.arange(nh, device=device)
    false = fill(False, torch.bool)
    program.hold((consts, e_vec, sel_rows, false))
    # a traced program's refinement count and cone regions (``graphs``),
    # where the structure has cones: an LP program's graphs keep their nodes
    probes = program.probe() if st.n_sc else None

    def prologue(G, A, c, h, b) -> _Prologue:
        """Equilibration, the KKT context, the init factor (identity
        scalings) and the start of the two init systems' refined solve."""
        eq = equilibrate(st, G, A, c, h, b, iters=settings.equil_iters)
        c, h, b = eq.c, eq.h, eq.b
        res0s = (torch.clamp(_norm(c), min=1.0),
                 torch.clamp(_norm(b), min=1.0),
                 torch.clamp(_norm(h), min=1.0))
        ctx = kkt.make_context(st, eq.G, eq.A, settings)
        init = kkt.factor(st, ctx, None, settings, lanes)
        rhs = torch.stack([torch.cat([zeros(lanes, n), b, h], -1),
                           torch.cat([-c, zeros(lanes, p + m)], -1)], 1)
        return _Prologue(eq=eq, res0s=res0s, ctx=ctx, init=init, rhs=rhs,
                         ref=kkt.refine_start(st, ctx, init, None, rhs,
                                              settings))

    def trip(ctx, solve, scal, rhs, ref: kkt.RefineState) -> None:
        kkt.refine_trip(st, ctx, solve, scal, rhs, settings, ref)

    def init_state(pro: _Prologue, state: LoopState) -> None:
        """The loop's first state, from the init systems' solutions,
        written into ``state`` in place."""
        graphs.copy_into(state, _first_state(pro))

    def _first_state(pro: _Prologue) -> LoopState:
        r, eq = pro.ref, pro.eq
        nan = fill(torch.nan)
        it0 = Iterate(
            x=r.dx[:, 0], y=r.dy[:, 1],
            z=cones.bring_to_cone(cone, r.dz[:, 1], gamma),
            s=cones.bring_to_cone(cone, -r.dz[:, 0], gamma),
            kap=fill(1.0), tau=fill(1.0), cx=fill(0.0), by=fill(0.0),
            hz=fill(0.0), pcost=nan, dcost=nan, gap=nan, relgap=nan,
            has_relgap=false, pres=nan, dres=nan, pinfres=nan,
            has_pinfres=false, dinfres=nan, has_dinfres=false, mu=nan,
            kapovert=nan, sigma=fill(0.0), step=fill(0.0),
            step_aff=fill(0.0), iter=fill(0, torch.int32),
            nitref1=r.kout[:, 0], nitref2=r.kout[:, 1],
            nitref3=fill(0, torch.int32))
        hist0 = History(*([torch.full((lanes, nh), torch.nan, dtype=dtype,
                                      device=device)] * 9
                          + [zeros(lanes, nh, dtype=torch.int32)] * 3))
        return LoopState(
            it=it0, best=it0, rhs1=torch.cat([-eq.c, eq.b, eq.h], -1),
            pres_prev=fill(torch.finfo(dtype).max),
            iter=fill(0, torch.int32),
            code=fill(int(ExitCode.FATAL), torch.int32), done=false,
            hist=hist0)

    def part_a(stt: LoopState, pro: _Prologue) -> _PartA:
        """Statistics, history, exit logic, scalings, the factor and the
        predictor solve's start."""
        ctx, eq = pro.ctx, pro.eq
        i = stt.iter
        (rx, ry, rz), rt, w = _statistics(st, settings, stt.it._replace(
            iter=i), ctx, eq.c, eq.h, eq.b, pro.res0s)
        sel = sel_rows[None, :] == i[:, None]

        def rec(row, val):
            return torch.where(sel, val[:, None], row)

        hist = History(*[rec(row, val) for row, val in zip(stt.hist, (
            w.pcost, w.dcost, w.gap, w.pres, w.dres, w.kapovert, w.mu,
            w.step, w.sigma, w.nitref1, w.nitref2, w.nitref3))])

        # ---- exit logic
        safeguard_trip = (i > 0) & ((w.pres > settings.safeguard
                                     * stt.pres_prev) | (w.gap < 0.0))
        code_full = full_check(w)
        full_conv = code_full != _NOTCONV
        zero_step = (i > 0) & (w.step == settings.stepmin * settings.gamma)
        maxit_hit = i == settings.iter_max
        nan_hit = torch.isnan(w.pcost)

        code_best_red = red_check(stt.best)
        red_or_numerics = torch.where(code_best_red == _NOTCONV,
                                      _NUMERICS, code_best_red)
        better = _is_better(w, stt.best)
        code_cur_red = red_check(w)
        maxit_code = torch.where(
            better,
            torch.where(code_cur_red == _NOTCONV, _MAXIT, code_cur_red),
            torch.where(code_best_red == _NOTCONV, _MAXIT, code_best_red))
        nan_keep = (i == 0) | better
        nan_code = torch.where(nan_keep, _NOTCONV, red_or_numerics)

        # priority: safeguard > full convergence > zero-step > maxit > NaN
        exit_now = (safeguard_trip | full_conv | zero_step | maxit_hit
                    | nan_hit)
        code = torch.full_like(i, _NOTCONV)
        restore = false
        code = torch.where(nan_hit, nan_code, code)
        restore = torch.where(nan_hit, ~nan_keep, restore)
        code = torch.where(maxit_hit, maxit_code, code)
        restore = torch.where(maxit_hit, ~better, restore)
        code = torch.where(zero_step, red_or_numerics, code)
        restore = restore | zero_step
        code = torch.where(full_conv, code_full, code)
        restore = restore & ~full_conv
        code = torch.where(safeguard_trip, red_or_numerics, code)
        restore = restore | safeguard_trip
        code = code.to(torch.int32)

        # ---- step computation; lanes exiting now need no step
        stepping = ~stt.done & ~exit_now
        with graphs.region("cones.scalings"):
            scal, lam = cones.update_scalings(cone, w.s, w.z)
        solve = kkt.factor(st, ctx, scal, settings, lanes)
        rhs_aff = torch.cat([rx, -ry, w.s - rz], -1)
        rhs = torch.stack([stt.rhs1, rhs_aff], 1)
        return _PartA(
            w=w, rx=rx, ry=ry, rz=rz, rt=rt, hist=hist, code=code,
            exit_now=exit_now, final_it=_where(restore, stt.best, w),
            best=_where((i == 0) | better, w, stt.best), stepping=stepping,
            scal=scal, lam=lam, solve=solve, rhs=rhs,
            ref=kkt.refine_start(st, ctx, solve, scal, rhs, settings,
                                 stepping))

    def part_b(stt: LoopState, a: _PartA, pro: _Prologue) -> _PartB:
        """The affine step, its line search, the combined right-hand side
        and its solve's start."""
        c, h, b = pro.eq.c, pro.eq.h, pro.eq.b
        w, scal, lam = a.w, a.scal, a.lam
        dx1, dy1, dz1 = a.ref.dx[:, 0], a.ref.dy[:, 0], a.ref.dz[:, 0]
        dx2, dy2, dz2 = a.ref.dx[:, 1], a.ref.dy[:, 1], a.ref.dz[:, 1]

        dtau_denom = (w.kap / w.tau - _dot(c, dx1) - _dot(b, dy1)
                      - _dot(h, dz1))
        dtauaff = (a.rt - w.kap + _dot(c, dx2) + _dot(b, dy2)
                   + _dot(h, dz2)) / dtau_denom

        dzaff = dz2 + dtauaff[:, None] * dz1
        W_dzaff = cones.scale(cone, scal, dzaff)
        dsaff_by_W = -W_dzaff - lam
        dkapaff = -w.kap - w.kap / w.tau * dtauaff
        with graphs.region("cones.line_search"):
            step_aff = cones.line_search(cone, lam, dsaff_by_W, W_dzaff,
                                         w.tau, dtauaff, w.kap, dkapaff,
                                         settings.stepmin, settings.stepmax)
        oms_aff = 1.0 - step_aff
        sigma = torch.clamp(oms_aff * (oms_aff * oms_aff),
                            settings.sigmamin, settings.sigmamax)

        # combined RHS
        ds1, _ = cones.conic_product(cone, lam, lam)
        ds2, _ = cones.conic_product(cone, dsaff_by_W, W_dzaff)
        sigmamu = sigma * w.mu
        ds = ds1 + ds2 - sigmamu[:, None] * e_vec
        lam_ds = cones.conic_division(cone, lam, ds)
        W_lam_ds = cones.scale(cone, scal, lam_ds)
        oms = (1.0 - sigma)[:, None]
        rhs = torch.cat([oms * a.rx, -oms * a.ry, -oms * a.rz + W_lam_ds],
                        -1)[:, None, :]
        return _PartB(
            dtau_denom=dtau_denom, dtauaff=dtauaff, dkapaff=dkapaff,
            sigma=sigma, sigmamu=sigmamu, step_aff=step_aff, lam_ds=lam_ds,
            rhs=rhs, ref=kkt.refine_start(st, pro.ctx, a.solve, scal, rhs,
                                          settings, a.stepping))

    def part_c(stt: LoopState, a: _PartA, b_: _PartB, pro: _Prologue) -> None:
        """The combined step, its line search and the new state, written
        into ``stt`` in place; lanes that have exited keep theirs."""
        c, h, b = pro.eq.c, pro.eq.h, pro.eq.b
        w, scal, lam = a.w, a.scal, a.lam
        dx1, dy1, dz1 = a.ref.dx[:, 0], a.ref.dy[:, 0], a.ref.dz[:, 0]
        dx2c, dy2c, dz2c = b_.ref.dx[:, 0], b_.ref.dy[:, 0], b_.ref.dz[:, 0]
        sigma, sigmamu = b_.sigma, b_.sigmamu

        bkap = w.kap * w.tau + b_.dkapaff * b_.dtauaff - sigmamu
        dtau = ((1.0 - sigma) * a.rt - bkap / w.tau + _dot(c, dx2c)
                + _dot(b, dy2c) + _dot(h, dz2c)) / b_.dtau_denom
        dx = dx2c + dtau[:, None] * dx1
        dy = dy2c + dtau[:, None] * dy1
        dz = dz2c + dtau[:, None] * dz1

        W_dz = cones.scale(cone, scal, dz)
        ds_by_W = -(b_.lam_ds + W_dz)
        dkap = -(bkap + w.kap * dtau) / w.tau
        with graphs.region("cones.line_search"):
            step = settings.gamma * cones.line_search(
                cone, lam, ds_by_W, W_dz, w.tau, dtau, w.kap, dkap,
                settings.stepmin, settings.stepmax)
        ds_final = cones.scale(cone, scal, ds_by_W)
        sc = step[:, None]
        stepped = w._replace(
            x=w.x + sc * dx, y=w.y + sc * dy, z=w.z + sc * dz,
            s=w.s + sc * ds_final, kap=w.kap + step * dkap,
            tau=w.tau + step * dtau, sigma=sigma, step=step,
            step_aff=b_.step_aff, nitref1=a.ref.kout[:, 0],
            nitref2=a.ref.kout[:, 1], nitref3=b_.ref.kout[:, 0])

        i = stt.iter
        cont = LoopState(it=stepped, best=a.best, rhs1=stt.rhs1,
                         pres_prev=w.pres, iter=i + 1,
                         code=torch.full_like(a.code, _NOTCONV), done=false,
                         hist=a.hist)
        exit_state = LoopState(it=a.final_it, best=stt.best, rhs1=stt.rhs1,
                               pres_prev=w.pres, iter=i, code=a.code,
                               done=~false, hist=a.hist)
        # exited lanes keep their state, as under vmap
        graphs.copy_into(stt, _where(stt.done, stt,
                                     _where(a.exit_now, exit_state, cont)))

    def finish(stt: LoopState, pro: _Prologue) -> Solution:
        eq = pro.eq
        if probes is not None:
            # every refined solve's steps: the init systems' in row 0, each
            # iteration's three in its row, zeros past a lane's last
            h = stt.hist
            probes.count_steps(h.nitref1 + h.nitref2 + h.nitref3)
        return _finish_solution(st, settings, eq, stt, pro.ctx,
                                (eq.c, eq.h, eq.b), pro.res0s)

    seg = program.segment
    return _Parts(
        prologue=seg("prologue", prologue),
        init_trip=seg("init refinement trip", trip, writes=(4,)),
        init_state=seg("loop state init", init_state, writes=(1,)),
        a=seg("iteration A", part_a),
        trip2=seg("refinement trip, 2 right-hand sides", trip, writes=(4,)),
        b=seg("iteration B", part_b),
        trip1=seg("refinement trip, 1 right-hand side", trip, writes=(4,)),
        c=seg("iteration C", part_c, writes=(0,)),
        finish=seg("finish", finish), first_state=_first_state)


def solve_batch(structure: ProblemStructure, data: ProblemData,
                settings: Settings = Settings(),
                live: Optional[LiveTable] = None,
                program: Optional[graphs.Program] = None) -> Solution:
    """Solve a batch of problems sharing ``structure``.  ``data`` holds
    float64 tensors on one device: c (L, n), h (L, m), b (L, p); G and A
    shared, (m, n) and (p, n), or per lane, (L, m, n) and (L, p, n).
    ``live`` prints the iteration table during the solve; without it,
    ``Settings(verbose_live=True)`` prints lane 0's rows as each
    iteration ends (a ``LiveTable`` of one trip a group).

    ``program`` (``program_for``): the segments of an earlier solve of
    the same key, replayed with ``data``'s values copied into its input
    buffers; on a CUDA tensor its first solve captures them.  Without
    one, the solve makes a program for itself and releases it at the end.
    The returned tensors are the caller's: no later solve changes them."""
    st = structure
    kkt.require_slice(st, settings)
    if live is None and settings.verbose_live:
        live = LiveTable()
    key = program_key(st, data, settings)
    own = program is None
    if own:
        program = graphs.Program(data.c.device, key)
    elif program.key != key:
        raise ValueError("the program was built for another structure, "
                         "settings or input shape")
    try:
        return _run(program, st, settings, data, live, adopt=own)
    finally:
        if own:
            program.close()


def _run(program: graphs.Program, st: ProblemStructure, settings: Settings,
         data: ProblemData, live: Optional[LiveTable], adopt: bool):
    """One solve through ``program``: one launch of its composed graph
    where it has one and no live table reads the loop, else the segments
    driven from the host (one flag read an init trip, an iteration and a
    refinement trip), after which a kept program composes.  Spanned:
    "program.load", "program.launch" or "program.host_driven", and
    "solver.clone"."""
    with timing.span("program.load"):
        inputs = program.load(_fields(data), adopt=adopt)
    if program.parts is None:
        program.parts = _parts(program, st, settings, data.c.shape[0],
                               data.c.dtype, data.c.device)
    parts = program.parts
    out = program.launch() if live is None else None
    if out is None:
        with timing.span("program.host_driven"):
            out = _steps(program, parts, inputs, _host_call, _host_loop,
                         live)
        if program.composes and program.loop is None:
            program.compose(lambda call, loop: _steps(program, parts,
                                                      inputs, call, loop))
    # the result's tensors are the program's (a graph's outputs, the loop
    # state): the caller gets copies
    with timing.span("solver.clone"):
        return graphs.clone(out)


def _host_call(segment: graphs.Segment, *args):
    return segment(*args)


def _host_loop(flag: torch.Tensor, body) -> None:
    while not kkt.all_true(flag):
        body()


def _steps(program: graphs.Program, parts: _Parts, inputs, call, loop,
           live: Optional[LiveTable] = None):
    """A solve's control flow over its segments, the JAX package's
    ``lax.while_loop``s: ``call(segment, *args)`` runs a segment and
    ``loop(flag, body)`` runs ``body()`` while not every entry of
    ``flag`` is true.  The host runs it with ``_host_call`` and
    ``_host_loop``; ``graphs.Program.compose`` records it into one graph.
    Returns the finish's ``Solution``."""
    pro = call(parts.prologue, *inputs)
    loop(pro.ref.done, lambda: call(parts.init_trip, pro.ctx, pro.init,
                                    None, pro.rhs, pro.ref))
    if program.state is None:
        program.state = program.hold(program.buffers(
            parts.first_state(pro)))
    state = program.state
    call(parts.init_state, pro, state)

    def iteration() -> None:
        # on the CPU the loop holds one factor at a time: a and b_ go
        # with the trip
        a = call(parts.a, state, pro)
        loop(a.ref.done, lambda: call(parts.trip2, pro.ctx, a.solve, a.scal,
                                      a.rhs, a.ref))
        b_ = call(parts.b, state, a, pro)
        loop(b_.ref.done, lambda: call(parts.trip1, pro.ctx, a.solve,
                                       a.scal, b_.rhs, b_.ref))
        call(parts.c, state, a, b_, pro)
        if live is not None:
            live.trip(state)

    loop(state.done, iteration)
    if live is not None:
        live.trip(state, last=True)
    return call(parts.finish, state, pro)


def _finish_solution(st, settings, eq, final: LoopState, ctx, cbh,
                     res0s) -> Solution:
    """Exit-time recheck of the certificates at the returned iterate, then
    backscale.  The code is upgraded when the recheck certifies a strictly
    better tier (definitive > reduced accuracy > failure), never
    downgraded.  The in-loop residuals are already exact f64 here, so the
    recheck repeats the reference's tail for parity."""
    c, h, b = cbh
    w = final.it
    code = final.code
    if st.dim_kkt and st.m:
        full_check, red_check = _checks(settings)
        _, _, w_re = _statistics(st, settings, w, ctx, c, h, b, res0s)
        code_re_full = full_check(w_re)
        code_re_red = red_check(w_re)
        cand = torch.where(code_re_full != _NOTCONV, code_re_full,
                           torch.where(code_re_red != _NOTCONV, code_re_red,
                                       code))

        def rank(cd):
            definitive = (cd == _OPT) | (cd == _PINF) | (cd == _DINF)
            reduced = (cd >= _OPT + _INACC) & (cd <= _DINF + _INACC)
            return torch.where(definitive, 2, torch.where(reduced, 1, 0))

        upgrade = rank(cand) > rank(code)
        code = torch.where(upgrade, cand, code)
        w = _where(upgrade, w_re, w)

    tau = w.tau[:, None]
    x = w.x / (eq.x_equil * tau)
    y = w.y / (eq.A_equil * tau)
    z = w.z / (eq.G_equil * tau)
    s = w.s * eq.G_equil / tau
    pinf = (code == _PINF) | (code == _PINF + _INACC)
    dinf = (code == _DINF) | (code == _DINF + _INACC)
    return Solution(exit_code=code, x=x, y=y, z=z, s=s, info=w, pinf=pinf,
                    dinf=dinf, history=final.hist)


def resolve_device(device=None) -> torch.device:
    """The device a solve runs on: ``None`` means CUDA, which must exist;
    the CPU (plain twins of the kernels) only when asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "eicos_tpu_torch solves on CUDA by default and no CUDA "
                "device is available; pass device='cpu' to run the plain "
                "torch path")
        return torch.device("cuda")
    return torch.device(device)


_FIELDS = ("G", "A", "c", "h", "b")


def lane_count(data: ProblemData, shared, lanes=None):
    """The lanes of the per-lane fields that ``data`` gives (those not in
    ``shared`` and not None), each of which must carry ``lanes`` where
    that is given: ``ValueError`` naming the first that differs.  None
    where ``data`` gives no per-lane field and ``lanes`` is None."""
    for f in _FIELDS:
        v = getattr(data, f)
        if v is None or f in shared:
            continue
        got = np.shape(v)[:1]
        if lanes is None and got:
            lanes = got[0]
        elif got != (lanes,):
            raise ValueError(f"{f} carries {got[0] if got else 'no'} lanes, "
                             f"the batch {lanes}")
    return lanes


def to_device(data: ProblemData, device, shared=None,
              kept: Optional[ProblemData] = None) -> ProblemData:
    """Move problem values to ``device`` as float64 tensors.  With
    ``shared=None`` ``data`` is one problem and gains a lane axis of 1;
    otherwise the fields not in ``shared`` carry a leading lane axis and
    the shared c/h/b are broadcast over the lanes (G and A stay shared).

    ``kept``: the device copy placed before (``update_data``).  A field
    that ``data`` leaves None keeps ``kept``'s tensor, neither converted
    nor copied; a per-lane field given must carry ``kept``'s lanes
    (``ValueError`` otherwise, before anything is placed).  The bytes
    that come from the host, or from another device, count in
    ``graphs.STATS`` "upload_bytes"; those that ``kept`` spared the
    placing (a broadcast field once) in "kept_bytes"."""
    lanes = None
    if shared is not None:
        shared = tuple(shared)
        lanes = lane_count(data, shared,
                           None if kept is None else kept.c.shape[0])
        if lanes is None:
            raise ValueError("a batch needs at least one per-lane field")
    vals, spared = {}, 0
    for f in _FIELDS:
        v = getattr(data, f)
        broadcast = f in ("c", "h", "b") and (shared is None or f in shared)
        if v is None:
            vals[f] = getattr(kept, f)
            spared += (vals[f][0] if broadcast else vals[f]).nbytes
            continue
        out = torch.as_tensor(v, dtype=torch.float64, device=device)
        if not (isinstance(v, torch.Tensor) and v.device == out.device):
            graphs.count_upload(out.nbytes)
        if broadcast:
            out = out[None] if shared is None else out.expand(lanes, -1)
        vals[f] = out
    if spared:
        graphs.count_kept(spared)
    return ProblemData(**vals)


def squeeze_lane(sol):
    """The single-problem view of a one-lane batch result."""
    if isinstance(sol, tuple):
        return type(sol)(*[squeeze_lane(v) for v in sol])
    return sol[0]


def solve(structure: ProblemStructure, data: ProblemData,
          settings: Settings = Settings(), device=None) -> Solution:
    """Solve one problem; ``device=None`` means CUDA."""
    dev = resolve_device(device)
    return squeeze_lane(solve_batch(structure, to_device(data, dev),
                                    settings))


def solve_live(structure: ProblemStructure, data: ProblemData,
               settings: Settings = Settings(), seg: int = 1, file=None,
               device=None) -> Solution:
    """``solve`` with the reference's iteration table printed during the
    solve (``eicos_tpu.solver.solve_live``): the header first, then the
    rows in groups of ``seg`` iterations, one host copy of the history a
    group.  Returns the same bits as ``solve``; ``device=None`` means
    CUDA."""
    dev = resolve_device(device)
    return squeeze_lane(solve_batch(structure, to_device(data, dev),
                                    settings, live=LiveTable(seg, file)))
