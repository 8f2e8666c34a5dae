"""The interactive loop on the CPU with wire-size mode-6 recordings (two
in the pool): it runs, its answers equal the reference's, the control
fails the cell's limits, and an altered answer is not correct."""

import contextlib
import io
import json
import pathlib
import shutil

import pytest

import run as bench_run
from harness import common, readings

REPO = pathlib.Path(__file__).resolve().parents[2]
TINY = {"loop": "interactive", "pool": 2, "pad_s": 1.0,
        "channel": {"awgn_db": -30.0, "cfo_hz": 234.567, "sfo_ppm": 147.0,
                    "spread": 10},
        "check_rows": 2, "trace_calls": 1}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny")
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = json.loads((REPO / "BENCHMARK.json").read_text())
    (root / "benchmark" / "traffic" / "tiny-i.json").write_text(
        json.dumps(TINY))
    limits = common.cell_of(m, "m6-8k.interactive", REPO)["limits"]
    (root / "benchmark" / "workloads" / "m6-8k.tiny-i.json").write_text(
        json.dumps({"limits": limits}))
    m["workloads"].append({"name": "m6-8k.tiny-i", "config": "m6-8k",
                           "traffic": "tiny-i", "chips": 1, "why": "tests"})
    for e in m["end_to_end"] + m["per_layer"]:
        if e["name"].endswith("interactive") or e["name"] == "decode_ms_p95":
            e["workloads"].append("m6-8k.tiny-i")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return root, common.cell_of(m, "m6-8k.tiny-i", root)


def run_tiny(root):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = bench_run.main(["--workload", "m6-8k.tiny-i", "--seed",
                             str(2 ** 40 + 3), "--seconds", "1"],
                            device="cpu", root=root)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


def test_the_interactive_loop_runs_and_agrees(tiny):
    rc, res = run_tiny(tiny[0])
    assert rc == 0 and res["correct"] is True
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"decode_ms_p95", "setup_s"}


def test_an_altered_answer_is_not_correct(tiny, monkeypatch):
    from modem_tpu_torch.decoder import Decoder
    real = Decoder.decode

    def decode(self, *a, **kw):
        res = real(self, *a, **kw)
        res.bit_flips += 1
        return res
    monkeypatch.setattr(Decoder, "decode", decode)
    rc, res = run_tiny(tiny[0])
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["calls_differ"]["value"] > 0


def test_the_control_fails_the_cells_limits(tiny):
    _, cell = tiny
    ctl = readings.readings(cell, 7, "cpu", control=True)
    assert any(ctl[k] > lim for k, lim in cell["limits"].items()), ctl
