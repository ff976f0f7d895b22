"""BENCHMARK.json against the benchmark's contract, and every file a cell
names found by its name."""

import json
import os
import re

import pytest

from yardstick import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SPEC_PATH = os.path.join(harness.ROOT, "BENCHMARK.json")


@pytest.fixture(scope="module")
def spec():
    assert os.path.getsize(SPEC_PATH) <= 64 * 1024
    return harness.load_json(SPEC_PATH)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_keys_and_paths(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(spec["paths"]) <= 16
    for p in spec["paths"]:
        assert PATH.match(p) and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(harness.ROOT, p))
    assert 1 <= len(spec["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") for w in spec["command"])
    script = spec["command"][1]
    assert any(script.startswith(p + "/") for p in spec["paths"])
    assert isinstance(spec["run_seconds"], int)
    assert 1 <= spec["run_seconds"] <= 51


def test_names_units_and_entries(spec):
    entries = (spec["configs"] + spec["workloads"] + spec["end_to_end"]
               + spec["per_layer"])
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in spec[kind]]
        assert len(names) == len(set(names))
    assert all(NAME.match(e["name"]) for e in entries)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    allowed_m = {"name", "unit", "better", "source", "workloads"}
    for m in spec["end_to_end"]:
        assert set(m) <= allowed_m | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) <= allowed_m | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in spec["paths"])
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in spec["workloads"]} == \
        {c["name"] for c in spec["configs"]}


def test_every_cell_reports_what_it_must(spec):
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        e2e = [m["name"] for m in spec["end_to_end"]
               if cell in m.get("workloads", cells)]
        per = [m for m in spec["per_layer"]
               if cell in m.get("workloads", cells)]
        assert "setup_s" in e2e and len(e2e) >= 2 and per
        assert all(m["moves"] in e2e for m in per)


def test_every_file_is_found_by_name(spec):
    for w in spec["workloads"]:
        cell = harness.load_cell(w["name"], spec)
        assert cell.config["name"] == w["config"]
        assert cell.traffic["entry"].startswith("vip_tpu_torch.")
        harness.load_module("references", cell.traffic["reference"])
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.load_module("metrics", m["name"]).read)
        assert set(cell.layers) == {m["layer"] for m in cell.per_layer}


def test_layer_files_name_bindings_that_exist():
    import importlib

    for f in sorted(os.listdir(os.path.join(harness.BENCH, "layers"))):
        with open(os.path.join(harness.BENCH, "layers", f)) as fh:
            for name in json.load(fh)["wrap"]:
                mod, attr = name.split(":")
                assert hasattr(importlib.import_module(mod), attr), name
