"""Object API: ``Solver`` (EiCOS's ``Solver`` constructor shape) and
``BatchedSolver`` (lanes sharing one structure), with the rescue pass: a
port of ``eicos_tpu.api``.

Both run on CUDA unless the caller passes ``device="cpu"``; without a CUDA
device they raise instead of moving to the CPU on their own.

Each object keeps the solve programs it runs (``graphs.Program``: on the
card, the solve captured as CUDA graphs at its first solve and replayed
by every later one, with the new values copied in), one for its settings
and one for its rescue: the update_data fast path, the counterpart of the
JAX package's cached executable.  A program holds device memory (its
graphs' pool, its input buffers, the loop state) until the object is
collected, ``close()`` is called, or a solve of another key (a batch of
another lane count, a rescue of another padded size) replaces it.

Each ``solve`` is one request of ``utils/timing``'s spans: "api.solve"
around it, and "api.update_data" around the ``update_data`` that prepares
it, with the same request number; inside them "api.place" (the values put
on the device: a new batch's every field, an ``update_data``'s fields
given), "api.codes" (the exit codes read back for the rescue),
"api.rescue" and "api.merge", and the solver's own spans.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .exitcodes import ExitCode
from .problem import ProblemData, make_problem
from .settings import Settings
from .parallel.sharding import shard_batch, solve_shards
from .solver import (LiveTable, Solution, program_for, resolve_device,
                     solve_batch, squeeze_lane, to_device)
from .structure import ProblemStructure
from .utils import timing

_FIELDS = ("G", "A", "c", "h", "b")


def _rescue_settings(rescue: Optional[Settings]) -> Optional[Settings]:
    """Normalize a rescue configuration as ``eicos_tpu.api`` does: a
    rescue left at ``dense_solve="auto"`` is pinned to the inverse path
    (the exact dense elimination); an explicit choice is kept."""
    if rescue is None or rescue.dense_solve != "auto":
        return rescue
    return dataclasses.replace(rescue, dense_solve="inverse")


def _code_rank(code: int) -> int:
    """Quality tier of an exit code: 2 = definitive answer (optimal or a
    full-accuracy infeasibility certificate), 1 = reduced-accuracy tier,
    0 = failure (NUMERICS/MAXIT/OUTCONE/...)."""
    if code in (0, 1, 2):
        return 2
    if code in (10, 11, 12):
        return 1
    return 0


class Solver:
    """Single-problem solver: Solver(G, A, c, h, b, soc_dims); l is
    inferred as m - sum(q).  A batch of one lane underneath.

    ``rescue``: optional fallback ``Settings``: when the primary exit is
    not definitive (``_code_rank`` below 2), the problem is solved once
    more under the fallback and the better result is kept.  The JAX
    package's last tier, an exact-f64 re-solve on the host CPU when its
    device computes in emulated f64, is not ported: the port computes in
    IEEE f64 on the card."""

    def __init__(self, G, A, c, h, b, soc_dims=(),
                 settings: Settings = Settings(),
                 rescue: Optional[Settings] = None, device=None):
        self.device = resolve_device(device)
        c = np.asarray(c, dtype=np.float64).reshape(-1)
        h = np.zeros(0) if h is None else np.asarray(h, np.float64).reshape(-1)
        b = np.zeros(0) if b is None else np.asarray(b, np.float64).reshape(-1)
        q = tuple(int(d) for d in (soc_dims if soc_dims is not None else ()))
        n, m, p = c.shape[0], h.shape[0], b.shape[0]
        l = m - sum(q)
        if l < 0:
            raise ValueError("sum of SOC dims exceeds number of cone rows")
        self.structure = ProblemStructure.create(n, p, m, l, q)
        self.settings = settings
        self._data = make_problem(self.structure, G, A, c, h, b)
        if settings.kkt_strategy == "banded":
            from .plan import make_band_plan

            self.structure = self.structure.with_band_plan(
                make_band_plan(self.structure, self._data.G, self._data.A,
                               block=settings.block))
        if settings.kkt_strategy in ("reduced", "banded", "normal"):
            self.structure = self.structure.with_gsplit(
                self._data.G, self._data.A)
        self.rescue = _rescue_settings(rescue)
        self._solution: Optional[Solution] = None
        self._dev: Optional[ProblemData] = None
        self._programs: dict = {}   # rescue? -> its kept program
        self._request: Optional[int] = None     # the next solve's

    @classmethod
    def from_csc(cls, n, m, p, l, ncones, q, Gpr, Gjc, Gir, Apr, Ajc, Air,
                 c, h, b, settings: Settings = Settings(),
                 rescue: Optional[Settings] = None, device=None):
        """The reference's "traditional interface", in its argument order:
        G (m, n) and A (p, n) in CSC arrays (values, column pointers, row
        indices; ``None`` values for an empty matrix), ``q[:ncones]`` the
        SOC sizes.  The object is built by ``__init__``, so ``device``,
        ``rescue`` and, under "banded", the band plan are set as there
        (``eicos_tpu``'s ``from_csc`` sets neither a rescue nor a band
        plan)."""
        import scipy.sparse as sp

        G = (sp.csc_matrix((Gpr, Gir, Gjc), shape=(m, n))
             if Gpr is not None else None)
        A = (sp.csc_matrix((Apr, Air, Ajc), shape=(p, n))
             if Apr is not None else None)
        qq = tuple(int(d) for d in (q[:ncones] if q is not None else ()))
        if l + sum(qq) != m:
            raise ValueError(f"l + sum(q) = {l + sum(qq)} != m = {m}")
        c = np.zeros(n) if c is None else c
        h = np.zeros(m) if h is None else h
        b = np.zeros(p) if b is None else b
        return cls(G, A, c, h, b, soc_dims=qq, settings=settings,
                   rescue=rescue, device=device)

    def update_data(self, G=None, A=None, c=None, h=None, b=None):
        """Replace problem values; dimensions must match.  The programs
        stay: the next solve replays them on the new values.  Only the
        fields given are placed on the device; the others keep their
        device copy, so a field changed in place must be passed again."""
        st = self.structure
        self._request = self._request or timing.new_request()
        with timing.span("api.update_data", request=self._request):
            given = ProblemData(
                G=None if G is None else make_problem(st, G, None, None, None,
                                                      None).G,
                A=None if A is None else make_problem(st, None, A, None, None,
                                                      None).A,
                c=(None if c is None
                   else np.asarray(c, np.float64).reshape(st.n)),
                h=(None if h is None
                   else np.asarray(h, np.float64).reshape(st.m)),
                b=(None if b is None
                   else np.asarray(b, np.float64).reshape(st.p)),
            )
            self._data = dataclasses.replace(self._data, **{
                f: getattr(given, f) for f in _FIELDS
                if getattr(given, f) is not None})
            if self._dev is not None:
                with timing.span("api.place"):
                    self._dev = to_device(given, self.device, kept=self._dev)
        self._solution = None

    def solve(self, verbose: bool = False) -> ExitCode:
        """Solve (and, under ``rescue``, re-solve once); with ``verbose``
        print the reference's iteration table and summary afterwards, from
        one host copy of the solution."""
        request, self._request = self._request or timing.new_request(), None
        with timing.span("api.solve", request=request):
            sol = self._solve(self.settings)
            with timing.span("api.codes"):
                code = int(sol.exit_code)
            if self.rescue is not None and _code_rank(code) < 2:
                with timing.span("api.rescue"):
                    rsol = self._solve(self.rescue, rescue=True)
                    if _code_rank(int(rsol.exit_code)) > _code_rank(code):
                        sol = rsol
        self._solution = sol
        if verbose:
            from .utils.printing import (host_copy, print_iteration_table,
                                         print_summary)

            host = host_copy(sol)
            print_iteration_table(host)
            print_summary(self.structure, host)
        return ExitCode(int(sol.exit_code))

    def solve_live(self, seg: int = 1, file=None) -> ExitCode:
        """``solve`` with the reference's iteration table printed during
        the solve, in groups of ``seg`` iterations (``solver.solve_live``),
        then the summary; no rescue, as in ``eicos_tpu``.  The solution has
        the same bits as ``solve()``'s."""
        from .utils.printing import host_copy, print_summary

        sol = self._solve(self.settings, live=LiveTable(seg, file))
        self._solution = sol
        print_summary(self.structure, host_copy(sol), file=file)
        return ExitCode(int(sol.exit_code))

    def _solve(self, settings: Settings, live=None, rescue: bool = False):
        """One solve under ``settings`` through the object's program for
        them (the rescue's with ``rescue``)."""
        # device-resident values, kept field by field by update_data
        if self._dev is None:
            with timing.span("api.place"):
                self._dev = to_device(self._data, self.device)
        program = program_for(self._programs.get(rescue), self.structure,
                              self._dev, settings, owner=self)
        self._programs[rescue] = program
        return squeeze_lane(solve_batch(self.structure, self._dev, settings,
                                        live=live, program=program))

    def close(self) -> None:
        """Release the device memory of the solver's programs; a later
        solve captures anew."""
        for program in self._programs.values():
            program.close()
        self._programs.clear()

    def solution(self) -> np.ndarray:
        """Primal solution x."""
        return self._solution.x.cpu().numpy()

    def get_info(self):
        return self._solution.info

    def get_settings(self) -> Settings:
        return self.settings

    @property
    def last_solution(self) -> Optional[Solution]:
        return self._solution


class BatchedSolver:
    """Lanes of problems sharing one structure, solved as one batch;
    converged lanes freeze until the batch finishes.

    ``shared`` names ProblemData fields identical across lanes, passed
    without a lane axis: the updateData sweep of EiCOS (same G/A, new c/h/b)
    maps to ``shared=("G", "A", "h")`` with per-lane c and b.  Shared G and
    A are equilibrated once and exist once on the device.

    ``rescue``: optional fallback ``Settings``.  The lanes whose exit is
    not definitive (``_code_rank`` below 2) are gathered into one batch and
    solved again under the fallback; a lane takes the fallback's result
    where its tier is better, and ``last_rescued`` lists those lanes.

    The rescue sub-batch is padded to the next power of two lanes by
    repeating its first lane, as ``eicos_tpu.api`` pads it, so that
    distinct failure counts share a few rescue programs; the object keeps
    the last one.  Lanes never couple, so the padding changes no lane's
    result.

    ``mesh``: optional sequence of devices (``parallel.make_mesh``): the
    lanes split evenly over it, the shared fields are copied to each
    device, the shards are solved at once, each through the object's
    program for its device, and the solution is gathered on ``mesh[0]``
    (``parallel/sharding.py``).  The rescue sub-batch is not sharded: it
    is small by construction, and a sub-mesh-size batch cannot split
    evenly.  ``device`` is then ``mesh[0]``."""

    def __init__(self, structure: ProblemStructure,
                 settings: Settings = Settings(), shared: tuple = (),
                 rescue: Optional[Settings] = None, device=None, mesh=None):
        self.mesh = None if mesh is None else tuple(mesh)
        self.device = (self.mesh[0] if self.mesh
                       else resolve_device(device))
        self.structure = structure
        self.settings = settings
        self.shared = tuple(shared)
        self.rescue = _rescue_settings(rescue)
        self.last_rescued: tuple = ()
        self._last_in = None
        self._last_dev = None
        # one program a device of the mesh (one without), and the rescue's
        self._programs: list = [None] * (len(self.mesh) if self.mesh
                                         else 1)
        self._rescue_program = None
        self._request: Optional[int] = None     # the next solve's

    def update_data(self, **fields) -> None:
        """Replace fields of the last batch (per-lane fields with their lane
        axis, shared ones without); the next ``solve()`` uses them.  Only
        the fields given are placed on the device; the others keep their
        device copy, so a field changed in place must be passed again.  A
        per-lane field must carry the batch's lanes (``ValueError``
        otherwise): another lane count is a new batch for ``solve``."""
        if self._last_in is None:
            raise ValueError("update_data needs a batch from solve() first")
        bad = set(fields) - set(_FIELDS)
        if bad:
            raise ValueError(f"unknown fields {sorted(bad)}")
        given = {f: v for f, v in fields.items() if v is not None}
        self._request = self._request or timing.new_request()
        with timing.span("api.update_data", request=self._request):
            self._last_dev = self._place(ProblemData(**{
                f: given.get(f) for f in _FIELDS}), kept=self._last_dev)
            self._last_in = ProblemData(**{
                f: given.get(f, getattr(self._last_in, f)) for f in _FIELDS})

    def _place(self, batch: ProblemData, kept=None):
        """The device copy of ``batch``: one batch, or its shards over the
        mesh; with ``kept``, the fields ``batch`` leaves None keep it."""
        with timing.span("api.place"):
            if self.mesh is None:
                return to_device(batch, self.device, self.shared, kept)
            return shard_batch(batch, self.mesh, self.shared, kept)

    def solve(self, batch: Optional[ProblemData] = None) -> Solution:
        """Solve ``batch`` (or the last one, after ``update_data``); the
        device copy of a batch is kept across repeated solves of it."""
        request, self._request = self._request or timing.new_request(), None
        with timing.span("api.solve", request=request):
            if batch is not None and batch is not self._last_in:
                self._last_in = batch
                self._last_dev = self._place(batch)
            if self._last_dev is None:
                raise ValueError("no batch to solve")
            shards = ([self._last_dev] if self.mesh is None
                      else self._last_dev)
            self._programs = [
                program_for(prog, self.structure, shard, self.settings, self)
                for prog, shard in zip(self._programs, shards)]
            if self.mesh is None:
                sols = solve_batch(self.structure, self._last_dev,
                                   self.settings, program=self._programs[0])
            else:
                sols = solve_shards(self.structure, self._last_dev,
                                    self.mesh, self.settings,
                                    programs=self._programs)
            if self.rescue is not None:
                sols = self._apply_rescue(sols)
            return sols

    def close(self) -> None:
        """Release the device memory of the solver's programs; a later
        solve captures anew."""
        for program in self._programs + [self._rescue_program]:
            if program is not None:
                program.close()
        self._programs = [None] * len(self._programs)
        self._rescue_program = None

    def _gather_lanes(self, idx) -> ProblemData:
        """The sub-batch of lanes ``idx`` on ``self.device``; shared G and
        A stay shared (c, h and b always carry a lane axis on the device).
        Under a mesh it is taken from the host batch."""
        if self.mesh is not None:
            host = np.asarray(idx.cpu())
            return to_device(ProblemData(**{
                f: (getattr(self._last_in, f) if f in self.shared
                    else np.asarray(getattr(self._last_in, f))[host])
                for f in _FIELDS}), self.device, self.shared)
        dev = self._last_dev
        return ProblemData(**{
            f: (getattr(dev, f) if f in self.shared and f in ("G", "A")
                else getattr(dev, f)[idx]) for f in _FIELDS})

    def _apply_rescue(self, sols: Solution) -> Solution:
        """Solve the lanes without a definitive exit once more under the
        rescue settings, as one batch padded to a power of two lanes with
        copies of its first, and merge in every lane whose tier improves.
        Fields whose per-lane shape differs between the two
        configurations (the history, iter_max + 1 long) keep the
        primary's values."""
        with timing.span("api.codes"):
            codes = sols.exit_code.cpu().numpy()
        lanes = np.flatnonzero([_code_rank(int(cd)) < 2 for cd in codes])
        self.last_rescued = ()
        if lanes.size == 0:
            return sols
        dev = sols.exit_code.device
        with timing.span("api.rescue"):
            nsub = 1 << int(lanes.size - 1).bit_length()
            padded = np.concatenate([lanes, np.repeat(lanes[:1],
                                                      nsub - lanes.size)])
            sub = self._gather_lanes(torch.as_tensor(padded, device=dev))
            self._rescue_program = program_for(self._rescue_program,
                                               self.structure, sub,
                                               self.rescue, self)
            rsols = solve_batch(self.structure, sub, self.rescue,
                                program=self._rescue_program)
            rcodes = rsols.exit_code.cpu().numpy()[:lanes.size]
        take = np.array([j for j in range(lanes.size)
                         if _code_rank(int(rcodes[j]))
                         > _code_rank(int(codes[lanes[j]]))], dtype=np.int64)
        if take.size == 0:
            return sols
        dest = torch.as_tensor(lanes[take], device=dev)
        src = torch.as_tensor(take, device=dev)

        def merge(full, sub):
            if isinstance(full, tuple):
                return type(full)(*[merge(f, s) for f, s in zip(full, sub)])
            if full.shape[1:] != sub.shape[1:]:
                return full
            out = full.clone()
            out[dest] = sub[src]
            return out

        self.last_rescued = tuple(int(v) for v in lanes[take])
        with timing.span("api.merge"):
            return merge(sols, rsols)

    @staticmethod
    def stack(problems, shared: tuple = ()) -> ProblemData:
        """Stack per-lane problems; ``shared`` fields are taken from the
        first problem and must be identical across lanes."""
        first = problems[0]
        vals = {}
        for f in _FIELDS:
            if f in shared:
                vals[f] = np.asarray(getattr(first, f))
            else:
                vals[f] = np.stack([np.asarray(getattr(pr, f))
                                    for pr in problems])
        return ProblemData(**vals)
