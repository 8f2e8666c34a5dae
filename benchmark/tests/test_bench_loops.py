"""A cell's loop is found by the name its traffic mix gives: a loop added
as a new file to a copy of the benchmark runs, and a name that is not
plain, or has no file, stops the run before any work."""

import contextlib
import io
import json
import pathlib
import shutil

import pytest

import run as bench_run

REPO = pathlib.Path(__file__).resolve().parents[2]
ECHO = '''"""A loop for the tests: no program, one fixed answer."""


def run(cell, seed, seconds, traced, device, t_start, root):
    return dict(attempted=3, failed=0, memory_peak_bytes=0,
                e2e={"decode_ms_p95": 12.5, "setup_s": 0.5}, per_layer={},
                device_extra={}, breakdown=None,
                checks={"calls_differ": (0, 0)})
'''


def copy_with_cell(tmp_path, loop, files=()):
    """A copy of the benchmark with the cell ``m6-8k.toy-loop`` whose mix
    names ``loop``, and extra harness files {name: source}."""
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "benchmark"
    for name, source in dict(files).items():
        (bench / "harness" / f"{name}.py").write_text(source)
    (bench / "traffic" / "toy-loop.json").write_text(json.dumps(
        {"loop": loop}))
    (bench / "workloads" / "m6-8k.toy-loop.json").write_text(json.dumps(
        {"limits": {"calls_differ": 0}}))
    m = json.loads((REPO / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "m6-8k.toy-loop", "config": "m6-8k",
                           "traffic": "toy-loop", "chips": 1,
                           "why": "tests"})
    for e in m["end_to_end"]:
        if e["name"] == "decode_ms_p95":
            e["workloads"].append("m6-8k.toy-loop")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    return tmp_path


def run_cell(root):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench_run.main(["--workload", "m6-8k.toy-loop", "--seed", "7",
                             "--seconds", "1"], device="cpu", root=root)
    return rc, out.getvalue(), err.getvalue()


def test_a_loop_added_as_a_file_runs_by_its_name(tmp_path):
    root = copy_with_cell(tmp_path, "echo_loop", {"echo_loop": ECHO})
    rc, out, _ = run_cell(root)
    assert rc == 0
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True and res["attempted"] == 3
    assert res["metrics"] == {"decode_ms_p95": {"value": 12.5, "unit": "ms"},
                              "setup_s": {"value": 0.5, "unit": "s"}}


@pytest.mark.parametrize("loop", ["no_such_loop", "Batch", "batch.py",
                                  "../harness/batch", "harness.batch", "",
                                  "1batch", "common", None, 3])
def test_an_unknown_or_unplain_loop_stops_the_run(tmp_path, loop):
    root = copy_with_cell(tmp_path, loop)
    rc, out, err = run_cell(root)
    assert rc != 0 and out == ""
    assert "no loop" in err


@pytest.mark.parametrize("loop", ["batch", "interactive", "recording"])
def test_the_committed_loops_resolve_to_their_modules(loop):
    import importlib
    mod = bench_run.loop_module(loop, REPO)
    assert mod is importlib.import_module(f"harness.{loop}")
