"""The readings that a cell's correctness limits are set from.

    python3 benchmark/harness/readings.py --workload <cell> \
        --seeds <n> ... [--control-seeds <n> ...] [--out <file.json>]

For each ``--seeds`` seed: the cell's pool made from it, decoded once
through the window's own calls (a batch cell: every pool batch through
``decode_batch_async`` then ``resolve``, and the rows a run keeps drawn
as a run draws them; an interactive or a recording cell: the recordings
a run compares, drawn from the seed), the program's state freed, and the
numbers compared against the plain reference: the lower readings.  For
each ``--control-seeds`` seed: the reference itself computed with every
stage's output rounded to bfloat16 (the control) in the program's
place, against the reference: the upper readings.  The benchmark's own
runs do not run this; it needs the card for the cells as committed and
runs on the CPU for the tests' toy cells (``device``).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path.insert(0, str(BENCH))
    sys.path.insert(1, str(BENCH.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import (batch, check, common, inputs, interactive,  # noqa: E402
                     recording)
from reference import modem as M  # noqa: E402
from reference.frontend import to_bf16  # noqa: E402


def readings(cell: dict, seed: int, device, control: bool = False) -> dict:
    """The numbers compared for one seed: the program's answers
    (control=False) or the bfloat16 control's, against the reference."""
    if cell["params"]["loop"] == "interactive":
        return interactive_readings(cell, seed, device, control)
    if cell["params"]["loop"] == "recording":
        return recording_readings(cell, seed, device, control)
    params = cell["params"]
    cfg = M.config_of(cell["config"]["modem"])
    device = torch.device(device)
    pool, sent = inputs.batch_pool(cfg, params, seed, device)
    rows = batch.sample_rows(params, seed, len(pool))
    recs = [pool[j].index_select(0, torch.as_tensor(rows[j], device=device))
            for j in range(len(pool))]
    kept = {j: [] for j in range(len(pool))}
    if control:
        del pool
        with torch.no_grad():
            low = check.reference_answers(cfg, cell["config"], recs, device,
                                          q=to_bf16)
        for j, ans in enumerate(low):
            kept[j].append(ans)
    else:
        pipe = batch.program_pipeline(cell["config"], device)

        def keep(j, host):
            kept[j].append({k: np.array(host[k][rows[j]])
                            for k in batch.RESULT_KEYS})

        batch.serve(pipe, pool, sent, range(len(pool)), keep=keep)
        del pipe, pool
    if device.type == "cuda":
        torch.cuda.empty_cache()
    with torch.no_grad():
        refs = check.reference_answers(cfg, cell["config"], recs, device)
    return check.compare(kept, refs)


def interactive_readings(cell: dict, seed: int, device, control: bool):
    """readings() of an interactive cell: each recording drawn from the
    seed decoded once by ``Decoder.decode`` (or by the control)."""
    params = cell["params"]
    cfg = M.config_of(cell["config"]["modem"])
    device = torch.device(device)
    pool, payloads, calls = interactive.mono_pool(cfg, params, seed, device)
    rows = [int(j) for j in interactive.sample(params, seed)]
    recs = [pool[j] for j in rows]
    if control:
        with torch.no_grad():
            low = interactive.reference_answers(cfg, cell["config"], recs,
                                                device, q=to_bf16)
        kept = {j: [_as_program(a)] for j, a in zip(rows, low)}
    else:
        dec = interactive.program_decoder(cell["config"], device)
        kept = {j: [] for j in rows}
        interactive.calls_loop(dec, pool, payloads, calls, rows,
                               keep=lambda j, r: kept[j].append(
                                   interactive.answer(r)))
        del dec
    with torch.no_grad():
        refs = dict(zip(rows, interactive.reference_answers(
            cfg, cell["config"], recs, device)))
    return interactive.compare(kept, refs)


def recording_readings(cell: dict, seed: int, device, control: bool):
    """readings() of a recording cell: each recording drawn from the
    seed decoded once by ``decode_recording_auto`` (or by the
    control)."""
    params = cell["params"]
    cfg = M.config_of(cell["config"]["modem"])
    device = torch.device(device)
    pool, sent = recording.hour_pool(cfg, params, seed, device)
    rows = [int(j) for j in recording.sample(params, seed)]
    if control:
        with torch.no_grad():
            low = recording.reference_answers(
                cfg, cell["config"], [pool[j] for j in rows], device,
                q=to_bf16)
        kept = {j: [_as_decode_all(a)] for j, a in zip(rows, low)}
    else:
        kept = {j: [] for j in rows}
        recording.calls_loop(pool, sent, cfg.rate, params, device, rows,
                             keep=lambda j, got: kept[j].append(got))
        recording.free_program()
    with torch.no_grad():
        refs = dict(zip(rows, recording.reference_answers(
            cfg, cell["config"], [pool[j] for j in rows], device)))
    return recording.compare(kept, refs)


def _as_decode_all(frames):
    """A reference answer in the form of decode_recording_auto's."""
    return [dict(pos=f["pos"], mode=f["mode"], call_sign=f["call_sign"],
                 ok=f["ok"], payload=f.get("payload", b""),
                 flips=f.get("flips"), snr=f.get("snr")) for f in frames]


def _as_program(a):
    """A reference answer in the form of interactive.answer's."""
    if a is None:
        return dict(ok=False, mode=-1, call="", symbol_pos=-1, payload=None,
                    flips=-1, sfo_ppm=0.0, snr=None)
    return dict(ok=bool(a.get("ok")), mode=a["mode"],
                call=M.base37_text(a["call"]), symbol_pos=a["symbol_pos"],
                payload=a.get("payload"), flips=a.get("flips", -1),
                sfo_ppm=a.get("sfo_ppm", 0.0),
                snr=a.get("snr"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    root = BENCH.parent
    common.cache_dirs(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = common.cell_of(common.load_json(root / "BENCHMARK.json"),
                          args.workload, root)
    out = {"workload": args.workload, "program": {}, "control": {}}
    for kind, seeds in (("program", args.seeds),
                        ("control", args.control_seeds)):
        for seed in seeds:
            t0 = time.perf_counter()
            got = readings(cell, seed, "cuda", control=kind == "control")
            out[kind][str(seed)] = got
            print(f"{args.workload} {kind} seed {seed}: {got} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
