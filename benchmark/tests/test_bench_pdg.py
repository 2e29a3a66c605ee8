"""The powered-descent cell on the CPU: its family against the plain
reference, its traffic and limits files, its two metric readers on records
made by hand, and a run of the cell at a small horizon."""

import numpy as np
import pytest
import torch

import harness
import mixes
from conftest import tiny
from reference import pdg

CELL = "pdg.mc128"


@pytest.fixture(scope="module")
def spec():
    return harness.load_cell(CELL)


def test_the_cell_finds_its_files(spec):
    assert spec["config"]["family"] == "pdg"
    assert spec["config"]["keep_soc"] is True
    assert spec["traffic"] == {"lanes": 128, "pool": 16, "c_sigma": 0.0,
                               "b_sigma": 0.01, "warm": 2,
                               "check_share": 0.05}
    assert spec["limits"]["nonoptimal_lanes"] == 0
    assert spec["limits"]["cone"] == 1e-12
    assert spec["limits"]["iter_max"] == 100
    assert {m["name"] for m in spec["per_layer"]} == {
        "cones.soc_ms", "solver.refine_steps"}


def test_the_plant_opens_b_with_the_initial_state(spec):
    """The family's plant at a small horizon: b opens with r0 and v0 (the
    entries the traffic disperses), its sizes, and the seed unread."""
    cfg = dict(spec["config"], horizon=6)
    G, A, c, h, b, l, q = mixes.family("pdg")(cfg, 12345)
    P = pdg.constants(cfg)
    np.testing.assert_allclose(b[:3], P["r0"])
    np.testing.assert_allclose(b[3:6], P["v0"])
    assert G.shape == (l + sum(q), 11 * 7) and A.shape == (13 + 7 * 6, 77)
    # the family does not read its seed
    G2, A2, c2, h2, b2, _, _ = mixes.family("pdg")(cfg, 99)
    for u, v in ((G, G2), (A, A2), (c, c2), (h, h2), (b, b2)):
        np.testing.assert_array_equal(u, v)


def test_a_run_at_a_small_horizon(spec):
    """The cell at horizon 8 and 4 lanes through the harness on CPU
    tensors: every lane OPTIMAL and the comparison passes."""
    small = tiny(CELL, horizon=8, lanes=4)
    result, run = harness.execute(small, 2 ** 33 + 5, 0.2, False,
                                  device="cpu")
    assert result["correct"] and result["failed"] == 0
    for name, c in result["checks"].items():
        assert c["value"] <= c["limit"], name


def record(**stats):
    return dict(batches=[dict(lanes=128), dict(lanes=128)], window_s=1.0,
                stats=stats)


def test_the_readers():
    soc = harness.reader("cones.soc_ms")
    steps = harness.reader("solver.refine_steps")
    rec = record(regions_ns={"cones.scalings": 3_000_000,
                             "cones.kept_blocks": 1_000_000,
                             "cones.line_search": 2_000_000},
                 refine_steps=7680)
    assert soc(rec) == pytest.approx(3.0)
    assert steps(rec) == pytest.approx(30.0)
    # nothing recorded: an untraced program, the parent, the CPU
    for empty in (record(), record(regions_ns={})):
        assert soc(empty) is None and steps(empty) is None


def test_the_program_counts_refinement_steps():
    """On CPU tensors a traced kept program counts its steps in its
    probes, and the finish adds every lane's each solve."""
    import eicos_tpu_torch as pt
    from eicos_tpu_torch import graphs
    from eicos_tpu_torch.plan import make_band_plan

    cfg = dict(harness.load_cell(CELL)["config"], horizon=6)
    G, A, c, h, b, l, q = mixes.family("pdg")(cfg, 0)
    st = pt.ProblemStructure.create(G.shape[1], A.shape[0], G.shape[0], l,
                                    q).with_gsplit(G, A)
    st = st.with_band_plan(make_band_plan(st, G, A, keep_soc=True))
    bs = pt.BatchedSolver(st, pt.Settings(kkt_strategy="banded"),
                          shared=("G", "A", "h"), device="cpu")
    sol = bs.solve(pt.ProblemData(G=G, A=A, c=np.stack([c, c]), h=h,
                                  b=np.stack([b, b])))
    probes = bs._programs[0].probes
    assert probes is not None and probes.regions == ()
    h_ = sol.history
    want = int((h_.nitref1 + h_.nitref2 + h_.nitref3).sum())
    assert int(probes.cells[0]) == want > 0
    assert isinstance(graphs.STATS, dict)
    bs.close()
    assert torch.equal(sol.exit_code, torch.zeros(2, dtype=torch.int32))
