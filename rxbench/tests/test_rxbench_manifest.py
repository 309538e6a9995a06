"""BENCHMARK.json keeps to the contract, and every file a cell or a
metric names is found by name."""

import json

import pytest

from rxbench.lib import manifest as mf

MAN = mf.load()
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(MAN) == KEYS
    assert MAN["command"] == ["python3", "rxbench/run.py"]
    assert MAN["paths"] == ["rxbench"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51


def test_names_and_units_keep_to_the_allowed_characters():
    names = [e["name"] for sec in ("configs", "workloads", "end_to_end", "per_layer")
             for e in MAN[sec]]
    names += [w["config"] for w in MAN["workloads"]] + [w["traffic"] for w in MAN["workloads"]]
    names += [k for c in MAN["configs"] for k in c["reduced"]]
    for n in names:
        assert mf.NAME.match(n), n
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert mf.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for sec in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [e["name"] for e in MAN[sec]]
        assert len(seen) == len(set(seen))
    for text in ([w["why"] for w in MAN["workloads"]] + [c["why"] for c in MAN["configs"]]
                 + [m["layer"] for m in MAN["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metrics_follow_the_contract():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    assert "setup_s" in e2e
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_each_cells_files_are_found_by_name(cell):
    c = mf.cell(MAN, cell)
    assert c["chips"] in (1, 4)
    cfg = mf.config(c["config_entry"])
    assert cfg["name"] == c["config"]
    assert callable(mf.module("configs", c["config"]).System)
    assert callable(mf.module("reference", c["config"]).Reference)
    mix = mf.traffic(c["traffic"])
    assert mix["name"] == c["traffic"]
    for k in [mix["camera"]] + mix["dynamic"]:
        assert mf.kind(k["kind"])
    assert set(mf.limits(cell)) == {"coverage_share", "dark_share", "refl_gap"}
    for m in mf.metrics_of(MAN, cell, "per_layer") + mf.metrics_of(MAN, cell, "end_to_end"):
        assert callable(mf.module("metrics", m["name"]).read)
    assert mf.metrics_of(MAN, cell, "per_layer")
    assert {m["name"] for m in mf.metrics_of(MAN, cell, "end_to_end")} > {"setup_s"}


def test_every_configuration_is_used_and_its_file_is_its_own():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith("rxbench/")


def test_a_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_the_manifest_is_small():
    assert len(json.dumps(MAN)) <= 64 * 1024
