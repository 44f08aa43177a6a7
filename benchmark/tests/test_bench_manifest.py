"""BENCHMARK.json and every file it names parse and keep the benchmark's
rules: names, units, lengths, the files found by name, the check's budget."""

import json
import os
import re

import pytest

from benchmark import harness

ROOT = harness.ROOT
BENCH = harness.BENCH
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def man():
    return harness.load_manifest()


def _text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(man["command"]) <= 32 and all(_text_ok(w) for w in man["command"])
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    for w in man["command"][1:]:
        if w.endswith(".py"):
            assert any(w.startswith(p + "/") for p in man["paths"])


def test_run_seconds_fits_the_check(man):
    rs = man["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_well_formed(man, group):
    names = [e["name"] for e in man[group]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs(man):
    files = set()
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _text_ok(c["source"]) and _text_ok(c["why"])
        assert any(c["file"].startswith(p + "/") for p in man["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert os.path.exists(os.path.join(ROOT, cfg["scene"]))
        assert os.path.exists(os.path.join(BENCH, "reference", cfg["reference"] + ".py"))
        assert any(w["config"] == c["name"] for w in man["workloads"])


def test_workloads(man):
    confs = {c["name"] for c in man["configs"]}
    pairs = set()
    four = 0
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in confs and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _text_ok(w["why"])
        four += w["chips"] == 4
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        _, _, traffic, _ = harness.load_cell(w["name"])
        assert os.path.exists(os.path.join(BENCH, "drivers", traffic["driver"] + ".py"))
        W, H = traffic["film"]
        tx, ty = traffic["tiles"]
        assert W % tx == 0 and H % ty == 0
        assert traffic["limits"]["nonfinite_px"] == 0
    assert four <= max(1, len(man["workloads"]) // 4)


def test_metrics(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    cells = {w["name"] for w in man["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in man["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert _text_ok(m["layer"]) and m["moves"] in e2e
        for c in m.get("workloads", cells):
            assert c in cells
            assert "workloads" not in e2e[m["moves"]] or c in e2e[m["moves"]]["workloads"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py"))
    for c in cells:   # every cell: setup_s, another end-to-end metric, a per-layer one
        assert len(harness.metrics_for(man, c, False)) >= 2
        assert harness.metrics_for(man, c, True)


def test_every_file_under_paths_is_named_from_name_characters(man):
    for p in man["paths"]:
        for dirpath, dirnames, files in os.walk(os.path.join(ROOT, p)):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for f in files:
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                assert PATH.match(rel), rel
