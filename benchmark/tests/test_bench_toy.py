"""The whole run on the CPU at a toy size: a cell added as files only
runs, the generator repeats for a seed, and a broken timed path makes
``correct`` false.  The run's look for a card is skipped (``device``)."""

import contextlib
import io
import json
import pathlib

import numpy as np
import pytest
import torch

import run as bench_run
from harness import inputs
from reference import modem as M
from toycell import TOY_CONFIG, add_toy_cell, toy_params

REPO = pathlib.Path(__file__).resolve().parents[2]
SEED = 2 ** 33 + 17          # larger than 32 signed bits hold


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("toy")
    name = add_toy_cell(REPO, root)
    return root, name


def run_cell(root, name, trace=0, seed=SEED):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench_run.main(["--workload", name, "--seed", str(seed),
                             "--seconds", "1", "--trace", str(trace)],
                            device="cpu", root=root)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


@pytest.mark.parametrize("trace", [0, 1])
def test_a_toy_cell_added_as_files_runs(toy_root, trace):
    root, name = toy_root
    rc, res, err = run_cell(root, name, trace)
    assert rc == 0
    assert res["correct"] is True
    assert res["attempted"] > 0 and res["failed"] < res["attempted"]
    assert list(res)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check ")
    if trace:
        assert res["metrics"]["escalated_pct.batch"]["value"] > 0
        assert "dispatch_ms.batch" in res["metrics"]
    else:
        assert set(res["metrics"]) == {"frames_per_s", "batch_ms_p95",
                                       "setup_s"}


def test_the_command_refuses_to_run_without_a_card(toy_root,
                                                    monkeypatch):
    root, name = toy_root
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = bench_run.main(["--workload", name, "--seed", "1",
                             "--seconds", "1"], root=root)
    assert rc != 0 and out.getvalue() == ""


@pytest.mark.parametrize("awgn_db", [None, -5.0])
def test_the_generator_repeats_for_a_seed(awgn_db):
    cfg = M.config_of(TOY_CONFIG["modem"])
    params = toy_params(awgn_db)
    a, sa = inputs.batch_pool(cfg, params, SEED, "cpu")
    b, sb = inputs.batch_pool(cfg, params, SEED, "cpu")
    c, sc = inputs.batch_pool(cfg, params, SEED + 1, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(np.array_equal(x, y) for x, y in zip(sa, sb))
    assert not torch.equal(a[0], c[0]) and not np.array_equal(sa[0], sc[0])
    # every recording its own payload
    assert len({row.tobytes() for row in sa[0]}) == params["batch"]


def broken(kind):
    """AdaptivePipeline.resolve with a fault planted in its answer."""
    from modem_tpu_torch.pipeline import AdaptivePipeline
    real = AdaptivePipeline.resolve
    last = {}

    def resolve(self, handle):
        host = real(self, handle)
        if kind == "altered":             # one answer altered
            host["bits"][0, 3] ^= 1
        elif kind == "half":              # half the batch left out
            half = len(host["ok"]) // 2
            for v in host.values():
                v[half:] = v[:1]
        elif kind == "stale":             # the state returned unchanged
            prev = last.get("host")
            last["host"] = {k: v.copy() for k, v in host.items()}
            if prev is not None:
                host = prev
        return host
    return resolve


@pytest.mark.parametrize("kind", ["altered", "half", "stale"])
def test_a_broken_timed_path_is_not_correct(toy_root, monkeypatch, kind):
    from modem_tpu_torch.pipeline import AdaptivePipeline
    root, name = toy_root
    monkeypatch.setattr(AdaptivePipeline, "resolve", broken(kind))
    rc, res, _ = run_cell(root, name)
    assert rc == 0
    assert res["correct"] is False
    assert res["checks"]["frames_differ"]["value"] > 0
