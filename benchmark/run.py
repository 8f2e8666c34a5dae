"""Run one cell of the benchmark of ``modem_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  Prints, as the last line of standard output, one JSON object:
correct, attempted, failed, metrics (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), device (and
with ``--trace 1`` breakdown), and last the numbers compared with their
limits (``checks``), which also end standard error.  Exits non-zero,
printing no result, without CUDA or with fewer cards than the cell
asks for, and if jax, jaxlib, flax or the JAX package is loaded once the
window has closed.

A cell's traffic mix names its loop (``"loop": "<name>"``): the module
``benchmark/harness/<name>.py``, imported as ``harness.<name>``, whose
``run`` drives the program.  A name that is not plain
(``[a-z][a-z0-9_]*``) or has no such file stops the run before any work.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import pathlib
import re
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(ROOT))

from harness import common  # noqa: E402

T_START = common.process_start()
FORBIDDEN = ("jax", "jaxlib", "flax", "modem_tpu")
LOOP_NAME = re.compile(r"[a-z][a-z0-9_]*")


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def loop_module(name, root: pathlib.Path):
    """The module of the loop ``name``: ``harness.<name>``, from
    ``root``'s benchmark/harness/; None for a name that is not plain, has
    no file there, or whose module has no ``run``."""
    if not isinstance(name, str) or not LOOP_NAME.fullmatch(name):
        return None
    path = root / "benchmark" / "harness" / f"{name}.py"
    if not path.is_file():
        return None
    if (BENCH / "harness" / f"{name}.py").is_file():
        mod = importlib.import_module(f"harness.{name}")
    else:       # a loop that only a copy of the benchmark has (CPU tests)
        spec = importlib.util.spec_from_file_location(f"harness.{name}",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
    return mod if callable(getattr(mod, "run", None)) else None


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device: str = "cuda", root: pathlib.Path = ROOT) -> int:
    """``device`` and ``root`` exist for the CPU tests; the command line
    always runs on the card of the checkout it is started in."""
    args = parse(argv)
    common.cache_dirs(root)
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    common.note("torch imported", time.time() - T_START)
    manifest = common.load_json(root / "BENCHMARK.json")
    cell = common.cell_of(manifest, args.workload, root)
    loop = loop_module(cell["params"].get("loop"), root)
    if loop is None:
        print(f"benchmark: {args.workload}: no loop "
              f"{cell['params'].get('loop')!r} in benchmark/harness/",
              file=sys.stderr)
        return 2
    chips = cell["entry"]["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device == "cuda" and found < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s); "
              f"found {found}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for m in cell["per_layer"]:
        m["_read"] = common.reader(root, m["name"])
    out = loop.run(cell, args.seed, args.seconds, bool(args.trace), device,
                   T_START, root)

    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    checks = out["checks"]
    correct = bool(checks) and all(v <= lim for v, lim in checks.values())
    if args.trace:
        wanted = {m["name"]: m["unit"] for m in cell["per_layer"]}
        values = out["per_layer"]
    else:
        wanted = {m["name"]: m["unit"] for m in cell["end_to_end"]}
        values = out["e2e"]
    metrics = {k: {"value": float(values[k]), "unit": u}
               for k, u in wanted.items()
               if values.get(k) is not None and math.isfinite(values[k])}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": chips, "memory_peak_bytes": int(out["memory_peak_bytes"]),
           **out["device_extra"]}
    result = {"correct": correct, "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": dev}
    if args.trace and out["breakdown"]:
        result["breakdown"] = out["breakdown"]
    result["checks"] = {
        k: {"value": float(v) if math.isfinite(v) else None,
            "limit": float(lim)} for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
