"""What every loop of the benchmark shares: the manifest and a cell's
files, seeds, statistics, the cache directories, the process clock, the
garbage collector's state in the window and the progress notes.

A cell is found by name: its entry in ``BENCHMARK.json`` names a
configuration (``configs[].file``) and a traffic mix
(``benchmark/traffic/<mix>.json``); ``benchmark/workloads/<cell>.json``,
where present, overrides the mix's parameters for that cell and holds
its correctness limits.  A per-layer metric is read by
``benchmark/metrics/<metric>.py``.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import importlib.util
import json
import os
import pathlib
import sys
import time

import numpy as np

_T_IMPORT = time.time()


def process_start() -> float:
    """The epoch second at which this process started (from /proc, to
    the clock tick), or the time this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _T_IMPORT


def cache_dirs(root: pathlib.Path) -> None:
    """Point the build and kernel caches at fixed directories inside the
    checkout (the program builds its own libraries under build/)."""
    build = root / "build"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.makedirs(build / sub, exist_ok=True)
        os.environ[var] = str(build / sub)


@contextlib.contextmanager
def old_objects_frozen():
    """The window with every object made in set-up moved out of the
    garbage collector's generations, as a long-running decoder's are
    old: a collection in the window then walks only what the window
    made."""
    gc.collect()
    gc.freeze()
    try:
        yield
    finally:
        gc.unfreeze()


def note(what: str, seconds: float) -> None:
    """A progress line on standard error (set-up split, window,
    reference), before the result's check lines."""
    print(f"bench: {what}: {seconds:.3f} s", file=sys.stderr, flush=True)


def seed_for(seed: int, label: str) -> int:
    """A 63-bit seed for one use of the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{label}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def percentile(values, pct: float) -> float:
    """Linear-interpolated percentile of all the values (numpy's
    default method)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), pct))


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_of(manifest: dict, name: str, root: pathlib.Path) -> dict:
    """Everything one cell runs with: its manifest entry, configuration,
    parameters (the mix's, then the cell file's), limits, and the
    metrics of each kind that apply to it."""
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    bench = root / "benchmark"
    params = load_json(bench / "traffic" / f"{entry['traffic']}.json")
    own = bench / "workloads" / f"{name}.json"
    limits = {}
    if own.exists():
        extra = load_json(own)
        limits = extra.pop("limits", {})
        params.update(extra)

    def applies(metric):
        return name in metric.get("workloads", [name])

    return dict(name=name, entry=entry, config=load_json(root / conf["file"]),
                params=params, limits=limits,
                end_to_end=[m for m in manifest["end_to_end"] if applies(m)],
                per_layer=[m for m in manifest["per_layer"] if applies(m)])


def reader(root: pathlib.Path, metric: str):
    """The read(run) function of benchmark/metrics/<metric>.py."""
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
