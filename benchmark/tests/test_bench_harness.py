"""The harness's control flow on CPU tensors at a small horizon (the
test-only entry ``harness.execute(..., device="cpu")``, which skips the
look for a card and reports no device metric), and the rule that the
traced run profiles only a new solver's first solve."""

import contextlib

import pytest

import harness
import mixes
from conftest import tiny

CELLS = ("mpc_lp.sweep128", "mpc_lp.tick16")
DEVICE_ONLY = {"peak_mem_gib", "device.busy_ms", "device.idle_share",
               "band_factor_bw_roofline"}


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_without_the_trace(cell):
    spec = tiny(cell)
    result, run = harness.execute(spec, 2 ** 31 + 11, 0.5, False,
                                  device="cpu")
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] == sum(b["lanes"] for b in run.batches) > 0
    want = {m["name"] for m in spec["end_to_end"]} - DEVICE_ONLY
    assert set(result["metrics"]) == want
    assert "device" not in result
    assert list(result)[-1] == "checks"
    for name, c in result["checks"].items():
        assert c["value"] <= c["limit"], name
    # a run's checks cover every batch's codes and the last batch's answers
    assert max(run.kept) == spec["traffic"]["warm"] + len(run.batches) - 1


def test_the_seed_draws_the_pool():
    """The same seed gives the same inputs, another seed other values of
    the same sizes; the plant is the configuration's."""
    import eicos_tpu_torch as pt

    spec = tiny("mpc_lp.sweep128", pool=5)
    one, two, other = (mixes.Sweep(pt, spec["config"], spec["traffic"], s,
                                   "cpu") for s in (5, 5, 2 ** 40 + 6))
    assert (one.plant.C == two.plant.C).all()
    assert (one.plant.Bv == two.plant.Bv).all()
    assert one.plant.C.shape == other.plant.C.shape == (5, 4, 48)
    assert not (one.plant.C == other.plant.C).any()
    assert (one.plant.G == other.plant.G).all()
    assert (one.plant.A == other.plant.A).all()


def test_set_up_captures_the_rescue_program():
    """Set-up runs the rescue once (a lane with c = NaN), on every seed,
    and the lanes beside it are answered as ever."""
    import eicos_tpu_torch as pt

    spec = tiny("mpc_lp.sweep128")
    mix = mixes.Sweep(pt, spec["config"], spec["traffic"], 9, "cpu")
    assert mix.bs._rescue_program is None
    mix.warm()
    assert mix.bs._rescue_program is not None
    out, _, _ = mix.run(spec["traffic"]["warm"], lambda: None)
    assert (out["code"] == 0).all() and out["rescued"] == ()


class Spy:
    """Records each ``BatchedSolver.solve`` call: the solver, how many
    solves it had made before, and whether a profile was open."""

    def __init__(self, monkeypatch):
        import eicos_tpu_torch as pt
        import torch.profiler

        self.calls, self.open, self.before = [], False, {}
        real_solve = pt.BatchedSolver.solve
        real_profile = torch.profiler.profile

        def solve(bs, *args, **kw):
            n = self.before.get(id(bs), 0)
            self.calls.append((id(bs), n, self.open))
            self.before[id(bs)] = n + 1
            return real_solve(bs, *args, **kw)

        @contextlib.contextmanager
        def profile(*args, **kw):
            with real_profile(*args, **kw) as prof:
                self.open = True
                try:
                    yield prof
                finally:
                    self.open = False

        monkeypatch.setattr(pt.BatchedSolver, "solve", solve)
        monkeypatch.setattr(torch.profiler, "profile", profile)


def test_the_trace_profiles_only_a_first_solve(monkeypatch):
    spy = Spy(monkeypatch)
    spec = tiny("mpc_lp.sweep128")
    result, run = harness.execute(spec, 3, 0.5, True, device="cpu")
    assert result["correct"]
    profiled = [c for c in spy.calls if c[2]]
    assert len(profiled) == 1
    solver, earlier, _ = profiled[0]
    assert earlier == 0            # a new solver's first solve
    window = {c[0] for c in spy.calls if not c[2]}
    assert solver not in window
    want = {m["name"] for m in spec["per_layer"]} - DEVICE_ONLY
    assert set(result["metrics"]) == want
    assert result["metrics"]["program.host_syncs"]["value"] > 0
