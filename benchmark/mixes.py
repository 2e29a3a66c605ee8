"""The one generator of traffic: a mix is a file ``traffic/<name>.json``
whose numbers size it.

A mix is a closed loop with one client: a batch's values are in host
memory, the client hands them to the port, waits for the results (exit
codes, x, y, z, s, iterations) in host memory, and only then sends the
next batch.  It is EiCOS's updateData sweep (src/run.cpp:43-50) through
one kept ``BatchedSolver``: the configuration's plant, shared G/A/h, and a
pool of ``pool`` batches of ``lanes`` lanes of per-lane c and initial
state drawn from the run's seed, cycled by ``update_data(c=, b=)`` then
``solve()``.

Set-up solves ``warm`` batches of the pool before the window: the first
captures and composes the solver's program, the next settles it.  Where
the configuration has a rescue, set-up also solves one batch whose first
lane the solver cannot finish (its c is NaN), so that the rescue's
program for one lane is captured there on every seed and not inside the
window on the seeds whose lanes need it.
"""

from __future__ import annotations

import importlib.util
import os
import time

import numpy as np

import frozen

HERE = os.path.dirname(os.path.abspath(__file__))
POOL_STREAM = 1      # seed_rng stream of the pool's lanes


def seed_rng(seed, stream):
    """An independent NumPy generator a purpose (``stream``) per seed; any
    whole number is a seed."""
    return np.random.default_rng([int(seed) % 2 ** 64, stream])


def family(name):
    """The ``make(config, seed)`` of ``families/<name>.py``."""
    path = os.path.join(HERE, "families", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_family_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make


def to_host(sol):
    """The results a client reads, in host memory."""
    return dict(code=sol.exit_code.cpu().numpy(), x=sol.x.cpu().numpy(),
                y=sol.y.cpu().numpy(), z=sol.z.cpu().numpy(),
                s=sol.s.cpu().numpy(), iters=sol.info.iter.cpu().numpy())


class Plant:
    """One plant's problem: G, A, c, h, b (NumPy), its cone split l, q and
    the per-lane c (batches, lanes, n) and b (batches, lanes, p)."""

    def __init__(self, config, rng, batches, lanes, traffic):
        make = family(config["family"])
        (self.G, self.A, c, self.h, b, self.l,
         self.q) = make(config, config["plant_seed"])
        self.C, self.Bv = frozen.perturbed_lanes(
            rng, c, b, batches, lanes, config["nx"], traffic["c_sigma"],
            traffic["b_sigma"])

    def batch(self, pt, k):
        return pt.ProblemData(G=self.G, A=self.A, c=self.C[k], h=self.h,
                              b=self.Bv[k])


class Sweep:
    """One kept solver; batch i is pool entry i mod ``pool``."""

    shared = ("G", "A", "h")

    def __init__(self, pt, config, traffic, seed, device, settings=None,
                 rescue=None):
        self.pt, self.config, self.traffic = pt, config, traffic
        self.device = device
        self.lanes = int(traffic["lanes"])
        self.settings = pt.Settings(**(settings or config["settings"]))
        rescue = config.get("rescue") if rescue is None else rescue
        self.rescue = pt.Settings(**rescue) if rescue else None
        self.pool = int(traffic["pool"])
        self.plant = Plant(config, seed_rng(seed, POOL_STREAM), self.pool,
                           self.lanes, traffic)
        self.st = self.structure(self.plant)
        self.bs = self.solver()
        self.started = False

    def structure(self, plant):
        """The plan layer: ``create``, ``with_gsplit``, ``with_band_plan``."""
        from eicos_tpu_torch.plan import make_band_plan

        st = self.pt.ProblemStructure.create(
            plant.G.shape[1], plant.A.shape[0], plant.G.shape[0], plant.l,
            plant.q)
        st = st.with_gsplit(plant.G, plant.A)
        if self.settings.kkt_strategy == "banded":
            st = st.with_band_plan(make_band_plan(
                st, plant.G, plant.A, keep_soc=self.config["keep_soc"]))
        return st

    def solver(self):
        return self.pt.BatchedSolver(self.st, self.settings,
                                     shared=self.shared, rescue=self.rescue,
                                     device=self.device)

    def band_shape(self):
        """(lanes, nb, bwb) of the band factor this mix runs, or None."""
        band = self.st.band
        if band is None:
            return None
        return self.lanes, band.dim // band.block, band.bwb

    def warm(self):
        """The set-up's batches: 0 .. warm - 1, and the rescue's."""
        warm = int(self.traffic["warm"])
        for i in range(warm):
            self.run(i, lambda: None)
            if i == 0 and self.rescue is not None:
                k = self.data(warm)[1]
                c = self.plant.C[k].copy()
                c[0] = np.nan
                self.bs.update_data(c=c, b=self.plant.Bv[k])
                to_host(self.bs.solve())

    def data(self, i):
        """(plant, pool entry) of batch i."""
        return self.plant, i % self.pool

    def run(self, i, mark):
        """One batch; returns (results, spans in s, the time the results
        were in host memory).  ``mark`` brackets the solve on its stream:
        after the upload has returned, and once ``solve`` has."""
        k = i % self.pool
        t0 = time.perf_counter()
        if self.started:
            self.bs.update_data(c=self.plant.C[k], b=self.plant.Bv[k])
            t1 = time.perf_counter()
            mark()
            sol = self.bs.solve()
        else:
            batch = self.plant.batch(self.pt, k)
            t1 = time.perf_counter()
            mark()
            sol = self.bs.solve(batch)
            self.started = True
        mark()
        t2 = time.perf_counter()
        out = to_host(sol)
        t3 = time.perf_counter()
        out["rescued"] = tuple(self.bs.last_rescued)
        return out, dict(upload=t1 - t0, solve=t2 - t1, readback=t3 - t2), t3

    def first_solve(self):
        """A new solver's first solve of batch 0 (host-driven: nothing of
        it has been captured or composed), released after."""
        bs = self.solver()
        try:
            to_host(bs.solve(self.plant.batch(self.pt, 0)))
        finally:
            bs.close()

    def close(self):
        self.bs.close()
