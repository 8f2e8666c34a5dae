"""The comparison's control: the reference computed with every stage
rounded to bfloat16, put in the program's place, must fail each cell's
limits; and the program must pass them.  At a toy size on the CPU, and at
each committed cell's own size on the card (three seeds)."""

import json
import pathlib

import pytest

from harness import common, readings
from toycell import add_toy_cell

REPO = pathlib.Path(__file__).resolve().parents[2]
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def fails(numbers: dict, limits: dict) -> list:
    return [k for k, lim in limits.items() if numbers[k] > lim]


def batch_limits():
    return [common.cell_of(MANIFEST, c, REPO)["limits"] for c in CELLS
            if common.cell_of(MANIFEST, c, REPO)["params"]["loop"] == "batch"]


@pytest.fixture(scope="module")
def toy_cell(tmp_path_factory):
    root = tmp_path_factory.mktemp("toyctl")
    name = add_toy_cell(REPO, root, traffic="toy-ctl", awgn_db=-5.0)
    return common.cell_of(json.loads((root / "BENCHMARK.json").read_text()),
                          name, root)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_control_fails_every_batch_cells_limits_at_a_toy_size(
        toy_cell, seed):
    ctl = readings.readings(toy_cell, seed, "cpu", control=True)
    prog = readings.readings(toy_cell, seed, "cpu")
    for limits in batch_limits():
        assert fails(ctl, limits), (ctl, limits)
        assert not fails(prog, limits), (prog, limits)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_and_the_program_passes_on_the_card(card, cell):
    c = common.cell_of(MANIFEST, cell, REPO)
    for seed in (5000000001, 5000000002, 5000000003):
        assert fails(readings.readings(c, seed, card, control=True),
                     c["limits"])
    assert not fails(readings.readings(c, 5000000004, card), c["limits"])
