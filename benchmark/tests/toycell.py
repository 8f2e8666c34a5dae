"""A toy cell added to a copy of the benchmark as files only: a small
numerology that the CPU decodes in seconds."""

import json
import shutil

ROOT_FILES = ("BENCHMARK.json",)
TOY_CONFIG = {"modem": {"rate": 8000, "symbol_len": 256, "freq_off": 0,
                        "mode": {"code_order": 10, "cons_cols": 32,
                                 "mod_bits": 2, "shorten": 64,
                                 "data_bits": 448}},
              "decoder": {"list_size": 8, "fallback_batch": 4,
                          "sync_stride": 8}}


def toy_params(awgn_db=None):
    chan = None
    if awgn_db is not None:
        chan = {"awgn_db": awgn_db, "cfo_hz": 0.0, "sfo_ppm": 0.0,
                "spread": 1}
    return {"loop": "batch", "batch": 8, "pool": 2, "pad_s": 0.05,
            "channel": chan, "check_rows": 4,
            "trace_batches": 2}


def add_toy_cell(repo, dest, traffic="toy-mix", awgn_db=-5.0, limits=None):
    """Copy BENCHMARK.json and benchmark/ to ``dest`` and add a toy
    configuration, traffic mix and cell, as new files plus manifest
    entries.  Returns the cell's name."""
    shutil.copytree(repo / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((repo / "BENCHMARK.json").read_text())
    bench = dest / "benchmark"
    (bench / "configs" / "toy.json").write_text(json.dumps(TOY_CONFIG))
    (bench / "traffic" / f"{traffic}.json").write_text(
        json.dumps(toy_params(awgn_db)))
    name = f"toy.{traffic}"
    limits = limits or {"frames_differ": 0, "snr_gap_db": 0.001,
                        "cfo_gap_rad": 1e-5}
    (bench / "workloads" / f"{name}.json").write_text(
        json.dumps({"limits": limits}))
    manifest["configs"].append({"name": "toy", "source": "toy",
                                "file": "benchmark/configs/toy.json",
                                "reduced": [], "why": "CPU tests"})
    manifest["workloads"].append({"name": name, "config": "toy",
                                  "traffic": traffic, "chips": 1,
                                  "why": "CPU tests"})
    for m in manifest["per_layer"] + manifest["end_to_end"]:
        if "workloads" in m and m["name"].endswith(".batch"):
            m["workloads"].append(name)
        elif "workloads" in m and m["name"] in ("frames_per_s",
                                                "batch_ms_p95"):
            m["workloads"].append(name)
    (dest / "BENCHMARK.json").write_text(json.dumps(manifest))
    return name
