"""BENCHMARK.json and the files the harness finds by name.

A cell's configuration is rxbench/configs/<config>.json (its sizes) with
rxbench/configs/<config>.py (`System`: the port set up for it and its
frame call) and rxbench/reference/<config>.py (`Reference`: the plain
reference's frames and the comparison); its traffic is
rxbench/traffic/<traffic>.json, whose camera and batch kinds are
rxbench/traffic/kinds/<kind>.py; its limits are rxbench/limits/<cell>.json;
every metric, end-to-end or per-layer, is rxbench/metrics/<name>.py.
Adding a cell or a metric adds files and entries, and edits none."""

from __future__ import annotations

import functools
import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    """The workload entry `name`, with its configuration entry under
    "config_entry"; raises KeyError naming what is missing."""
    for w in manifest["workloads"]:
        if w["name"] == name:
            for c in manifest["configs"]:
                if c["name"] == w["config"]:
                    return dict(w, config_entry=c)
            raise KeyError(f"configuration {w['config']!r} of cell {name!r}")
    raise KeyError(f"cell {name!r}")


def config(entry: dict, root: Path = ROOT) -> dict:
    return read_json(root / entry["file"])


def traffic(name: str) -> dict:
    return read_json(BENCH / "traffic" / f"{name}.json")


def limits(cell_name: str) -> dict:
    return read_json(BENCH / "limits" / f"{cell_name}.json")


@functools.lru_cache(maxsize=None)
def module(folder: str, name: str):
    """rxbench/<folder>/<name>.py as a module, loaded once."""
    path = BENCH / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"rxbench_{folder.replace('/', '_')}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(name: str):
    """A traffic kind: rxbench/traffic/kinds/<name>.py."""
    return module("traffic/kinds", name)


def metrics_of(manifest: dict, cell_name: str, section: str) -> list:
    """The metrics of `section` ("end_to_end" or "per_layer") that the cell
    reports: those without "workloads" and those that list it."""
    return [m for m in manifest[section]
            if "workloads" not in m or cell_name in m["workloads"]]
