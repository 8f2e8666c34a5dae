"""BENCHMARK.json against the benchmark's contract, and every cell's
files present."""

import json
import math
import pathlib
import re

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def reports(metric, cell):
    return cell in metric.get("workloads", CELLS)


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == KEYS
    assert len(json.dumps(MANIFEST)) <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert MANIFEST["command"][:2] == ["python3", "benchmark/run.py"]
    for p in MANIFEST["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_plain(kind):
    names = [e["name"] for e in MANIFEST[kind]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_units_and_directions(kind):
    for m in MANIFEST[kind]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_end_to_end_bounds():
    names = [m["name"] for m in MANIFEST["end_to_end"]]
    assert "setup_s" in names
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for cell in CELLS:
        e2e = [m["name"] for m in MANIFEST["end_to_end"] if reports(m, cell)]
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert any(reports(m, cell) for m in MANIFEST["per_layer"]), cell


def test_each_layer_metric_moves_what_its_cells_report():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    for spellings in layers.values():
        assert len(spellings) == 1


def test_configs_and_cells_have_their_files():
    bench = REPO / "benchmark"
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in MANIFEST["workloads"]}
    for c in MANIFEST["configs"]:
        assert c["name"] in used
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert json.loads((REPO / c["file"]).read_text())["modem"]
        assert len(c["reduced"]) <= 16
    pairs = set()
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert NAME.match(w["traffic"])
        assert (bench / "traffic" / f"{w['traffic']}.json").exists()
        limits = json.loads((bench / "workloads" /
                             f"{w['name']}.json").read_text())["limits"]
        assert limits and all(math.isfinite(v) and v >= 0
                              for v in limits.values())
    for m in MANIFEST["per_layer"]:
        assert (bench / "metrics" / f"{m['name']}.py").exists()


def test_run_budget_fits_with_full_cells():
    n = 24
    runs = 2 + 14 * n
    total = runs * (MANIFEST["run_seconds"] + 60) + n * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("mix", sorted(
    p.stem for p in (REPO / "benchmark" / "traffic").glob("*.json")))
def test_every_traffic_names_a_loop_of_the_harness(mix):
    params = json.loads((REPO / "benchmark" / "traffic" /
                         f"{mix}.json").read_text())
    loop = params["loop"]
    assert re.fullmatch(r"[a-z][a-z0-9_]*", loop), loop
    assert (REPO / "benchmark" / "harness" / f"{loop}.py").is_file(), loop
