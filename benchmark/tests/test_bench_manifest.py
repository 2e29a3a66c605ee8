"""``BENCHMARK.json`` against the rules it is written to, and the harness
finding each configuration, traffic mix, limit file and metric reader by
its name."""

import json
import os
import re

import pytest

import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds"} | set(KEYS)
    assert manifest["command"] == ["python3", "benchmark/run.py"]
    assert all(PATH.match(p) and ".." not in p for p in manifest["paths"])
    rs = manifest["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(manifest)) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(manifest, section):
    entries = manifest[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"])
        for key in ("why", "layer", "source"):
            if key in e:
                assert line(e[key]), (e["name"], key)
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        if section in ("end_to_end", "per_layer"):
            assert e["source"] in SOURCES
    if section == "end_to_end":
        assert "setup_s" in names
        for e in entries:
            assert e["source"] in ("host_clock", "device_trace")
            assert 0.01 <= e["bound"] <= 0.25


def test_configs_and_cells(manifest):
    cfgs = {c["name"]: c for c in manifest["configs"]}
    used = set()
    pairs = set()
    for w in manifest["workloads"]:
        assert w["config"] in cfgs and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
    assert used == set(cfgs)
    files = [c["file"] for c in cfgs.values()]
    assert len(files) == len(set(files))
    for c in cfgs.values():
        assert c["file"].startswith("benchmark/")
        assert len(c["reduced"]) <= 16
        assert c["source"].startswith("https://")


def test_every_cell_reports_what_it_must(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    for w in manifest["workloads"]:
        spec = harness.load_cell(w["name"])
        mine = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in mine and len(mine) >= 2
        assert spec["per_layer"]
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in {w["name"] for w in manifest["workloads"]}
            assert cell in e2e[m["moves"]].get("workloads", [cell])


def test_files_are_found_by_name(manifest):
    for w in manifest["workloads"]:
        spec = harness.load_cell(w["name"])
        with open(os.path.join(harness.HERE, "traffic",
                               w["traffic"] + ".json")) as fh:
            assert spec["traffic"] == json.load(fh)
        from reference import certificate

        for key in ("nonoptimal_lanes", "iter_max") + certificate.READINGS:
            assert key in spec["limits"]
        for key in ("family", "horizon", "nx", "nu", "settings", "rescue",
                    "control", "keep_soc", "plant_seed"):
            assert key in spec["config"]
        assert callable(__import__("mixes").family(spec["config"]["family"]))
    for m in manifest["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        harness.load_cell("no.such_cell")
