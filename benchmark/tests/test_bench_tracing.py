"""The readers of the program's own spans, upload counter and device
stamps (``graphs.STATS`` keys "spans", "upload_bytes", "launches",
"segments_ns") on a record made by hand: each reads its value, and each
reads None where the program records nothing (an untraced program, the
CPU, or a program without the keys)."""

import pytest

import harness

MS = 1_000_000       # ns


def span(name, start, end, request, parent=0, id_=None):
    return dict(name=name, start=start, end=end, id=id_ or start + 1,
                parent=parent, request=request, launch=None)


def record():
    """Two batches of one client on the host's clock, in ms: each an
    update_data (its place inside), a solve (the launch call inside), the
    launch on the card, the client's readback after; the second request
    has a rescue's launch too."""
    spans = [
        span("api.update_data", 0, 12 * MS, 1),
        span("api.place", 1 * MS, 11 * MS, 1, parent=1),
        span("api.solve", 12 * MS, 140 * MS, 1),
        span("program.launch", 13 * MS, 13 * MS + 200_000, 1),
        span("api.update_data", 150 * MS, 164 * MS, 2),
        span("api.place", 151 * MS, 163 * MS, 2, parent=151 * MS + 1),
        span("api.solve", 164 * MS, 300 * MS, 2),
        span("program.launch", 165 * MS, 165 * MS + 100_000, 2),
        span("program.launch", 290 * MS, 290 * MS + 300_000, 2),
    ]
    launches = [
        dict(request=1, index=0, device_ns=120 * MS,
             start_ns=14 * MS, end_ns=134 * MS),
        dict(request=2, index=1, device_ns=110 * MS,
             start_ns=166 * MS, end_ns=276 * MS),
        dict(request=2, index=0, device_ns=8 * MS,
             start_ns=290 * MS, end_ns=298 * MS),
    ]
    segments = {"prologue": 10 * MS, "init refinement trip": 4 * MS,
                "loop state init": 1 * MS, "iteration A": 90 * MS,
                "refinement trip, 2 right-hand sides": 50 * MS,
                "iteration B": 20 * MS,
                "refinement trip, 1 right-hand side": 30 * MS,
                "iteration C": 25 * MS, "finish": 8 * MS}
    return dict(batches=[{}, {}], window_s=0.4,
                stats=dict(spans=spans, launches=launches,
                           segments_ns=segments, upload_bytes=134_914_048))


# the idle time between launches: 134-166 ms (32 ms, of which 134-140 and
# 150-166 lie under the port's spans: 22 ms) and 276-290 ms (14 ms, all
# under the solve's span)
WANT = {
    "api.place_ms": 11.0,
    "api.upload_mb": 67.457024,
    "program.launch_call_ms": 0.2,
    "program.launch_device_ms": 119.0,
    "solver.part_a_ms": 45.0,
    "solver.refine_ms": 42.0,
    "device.launch_idle_share": 100.0 * (1.0 - 0.238 / 0.4),
    "device.idle_in_port_share": 100.0 * 36 / 46,
}


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_reads_the_program_record(metric):
    assert harness.reader(metric)(record()) == pytest.approx(
        WANT[metric], rel=1e-12)


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_reads_none_without_the_record(metric):
    read = harness.reader(metric)
    assert read(dict(batches=[{}], window_s=1.0, stats={})) is None
    empty = dict(spans=[], launches=[], segments_ns={}, upload_bytes=0)
    assert read(dict(batches=[{}], window_s=1.0, stats=empty)) is None


def test_the_manifest_lists_each_reader_for_both_cells():
    for cell in ("mpc_lp.sweep128", "mpc_lp.tick16"):
        names = {m["name"] for m in harness.load_cell(cell)["per_layer"]}
        assert set(WANT) <= names
