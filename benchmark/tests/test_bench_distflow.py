"""The day-ahead feeder cell on the CPU: its files found by name, the
family's plant opening b with the loads that the traffic disperses, a run
of the cell at a small horizon, the band work function against the frozen
bandwidth-1 count, and the cell's three readers on records made by hand."""

import numpy as np
import pytest

import frozen
import harness
import mixes
from band_work import band_factor_work_bw
from conftest import tiny
from reference import distflow

CELL = "dist33.mc128"
READERS = ("band.factor_ms", "band.sweep_ms", "band.factor_roofline")


@pytest.fixture(scope="module")
def spec():
    return harness.load_cell(CELL)


def test_the_cell_finds_its_files(spec):
    assert spec["config"]["family"] == "distflow"
    assert spec["config"]["keep_soc"] is True
    assert spec["config"]["reduced"] == []
    assert spec["traffic"] == {"lanes": 128, "pool": 16, "c_sigma": 0.0,
                               "b_sigma": 0.003, "warm": 2,
                               "check_share": 0.05}
    assert spec["limits"]["nonoptimal_lanes"] == 0
    assert spec["limits"]["cone"] == 1e-12
    assert spec["limits"]["iter_max"] == 100
    assert {m["name"] for m in spec["per_layer"]} == set(READERS)
    assert {m["name"] for m in spec["end_to_end"]} == {
        "solves_per_s", "batch_p90_ms", "peak_mem_gib", "setup_s"}


def test_the_plant_opens_b_with_the_loads(spec):
    """The family's plant at 3 hours: b opens with the 32 load buses' P
    loads an hour, then their Q loads (the entries the traffic disperses,
    64 an hour), the substation at v0 and the batteries' start follow; its
    sizes; the seed unread."""
    T = 3
    cfg = dict(spec["config"], horizon=T)
    G, A, c, h, b, l, q = mixes.family("distflow")(cfg, 12345)
    N = distflow.network(cfg)
    pl, ql = distflow.base_loads(N)
    np.testing.assert_allclose(b[:32 * T], pl.numpy().ravel())
    np.testing.assert_allclose(b[32 * T:64 * T], ql.numpy().ravel())
    hour = b[64 * T:].reshape(T, 39)
    assert (hour[:, 34] == 1.0).all()                  # v0
    np.testing.assert_allclose(hour[0, 35:], N["e_start"].numpy())
    assert not hour[1:, 35:].any() and not hour[:, :34].any()
    assert G.shape == (l + 4 * 32 * T, 143 * T) and A.shape == (103 * T,
                                                                143 * T)
    assert q == (4,) * (32 * T) and l == 88 * T
    G2, A2, c2, h2, b2, _, _ = mixes.family("distflow")(cfg, 99)
    for u, v in ((G, G2), (A, A2), (c, c2), (h, h2), (b, b2)):
        np.testing.assert_array_equal(u, v)


def test_a_run_at_a_small_horizon():
    """The cell at 4 hours and 3 lanes through the harness on CPU tensors
    (its dispersion on the 4 hours' loads): every lane OPTIMAL and the
    comparison passes."""
    small = tiny(CELL, horizon=4, lanes=3)
    small["config"] = dict(small["config"], nx=64 * 4)
    result, run = harness.execute(small, 2 ** 33 + 5, 0.2, False,
                                  device="cpu")
    assert result["correct"] and result["failed"] == 0
    for name, c in result["checks"].items():
        assert c["value"] <= c["limit"], name


@pytest.mark.parametrize("lanes,nb", [(1, 1), (16, 16), (128, 23)])
def test_the_band_work_is_the_frozen_one_at_bandwidth_1(lanes, nb):
    assert band_factor_work_bw(lanes, nb, 1) == frozen.band_factor_work(
        lanes, nb)


def test_the_band_work_at_bandwidth_2():
    """At bw 2: three blocks a row read and written beside the diagonal
    pair, and the second block row on of 6 B^3 and the leaf's 5/6 B^3."""
    B = frozen.B
    nbytes, ops = band_factor_work_bw(2, 5, 2)
    assert nbytes == 2 * 5 * (6 * B * B * 8 + B * 8)
    leaf = B ** 3 // 2 + B ** 3 // 3
    assert ops == 2 * (5 * leaf + 2 * B ** 3 + 3 * 6 * B ** 3)


def record(**stats):
    return dict(batches=[dict(lanes=128), dict(lanes=128)], window_s=1.0,
                stats=stats)


def test_the_readers():
    factor, sweeps, roof = (harness.reader(n) for n in READERS)
    rec = record(regions_ns={"band.factor": 40_000_000,
                             "band.sweeps": 60_000_000,
                             "cones.scalings": 1_000_000},
                 regions_runs={"band.factor": 4, "band.sweeps": 30},
                 band_shape=(71, 2))
    assert factor(rec) == pytest.approx(20.0)
    assert sweeps(rec) == pytest.approx(30.0)
    bound_ms, by = frozen.bound(*band_factor_work_bw(128, 71, 2))
    assert by == "bytes"
    assert roof(rec) == pytest.approx(100.0 * bound_ms / 10.0)
    # nothing recorded: an untraced program, the parent, the CPU
    for empty in (record(), record(regions_ns={}),
                  record(regions_ns={"cones.scalings": 1})):
        assert factor(empty) is None and sweeps(empty) is None
        assert roof(empty) is None
    # stamps without a recorded shape read no roofline
    assert roof(record(regions_ns={"band.factor": 1},
                       regions_runs={"band.factor": 1})) is None
