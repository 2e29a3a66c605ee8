"""The reader of ``kernels.factor_cluster_share``: the share of the band
factor's launches that took the cluster kernel, and None where the
program counts no cluster factor (as before it had one) or ran no band
factor."""

import pytest

import harness


@pytest.mark.parametrize("counts,want", [
    ({"band_factor_bw": 0, "band_factor_cluster": 272}, 100.0),
    ({"band_factor_bw": 272, "band_factor_cluster": 0}, 0.0),
    ({"band_factor_bw": 3, "band_factor_cluster": 1}, 25.0),
    ({"band_factor_cluster": 2}, 100.0),
    ({"band_factor_bw": 272}, None),
    ({"band_factor_bw": 0, "band_factor_cluster": 0}, None),
    ({}, None),
])
def test_the_share(counts, want):
    read = harness.reader("kernels.factor_cluster_share")
    got = read(dict(batches=[{}], window_s=1.0, stats={}, counts=counts))
    assert got == (None if want is None else pytest.approx(want))


def test_none_without_a_record():
    read = harness.reader("kernels.factor_cluster_share")
    assert read(dict(batches=[{}], window_s=1.0, stats={})) is None


def test_the_manifest_reports_it_in_the_lp_cells_alone():
    for cell, has in (("mpc_lp.sweep128", True), ("mpc_lp.tick16", True),
                      ("pdg.mc128", False)):
        names = {m["name"] for m in harness.load_cell(cell)["per_layer"]}
        assert ("kernels.factor_cluster_share" in names) == has, cell
