"""The control of each cell: the plain reference put in the program's place
one precision lower (TF32 for the analog cell's float32, fp8 for the LM's
bf16) fails the cell's limits; for the training cell also the fault that
leaves half of each batch out.  On the CPU at a reduced size, and on the
card at the cell's own size (marked ``gpu``)."""

import importlib
import time

import pytest

from bench import harness
from bench.test_bench_cells import SMALL


def control(cell: str, device: str, small: bool, seed: int = 2**31 + 21):
    spec = harness.cell_spec(cell)
    if small:
        cfg, traffic = SMALL[cell]
        spec["config"].update(cfg)
        spec["traffic"].update(traffic)
    driver = importlib.import_module(
        f"bench.drivers.{spec['traffic']['driver']}")
    ctx = harness.RunContext(device, seed, 1.0, False, time.perf_counter())
    return driver.control(spec["config"], spec["traffic"], spec["cell"],
                          ctx), spec["cell"]["limits"]


def fails(readings: dict, limits: dict) -> bool:
    return any(readings[k] > limits[k] for k in limits)


def check(cell, readings, limits):
    if cell == "granite-train-8x512":
        assert fails(readings["fp8"], limits), readings
        assert fails(readings["half_batch"], limits), readings
    else:
        assert fails(readings, limits), readings


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_fails_at_a_reduced_size(cell):
    check(cell, *control(cell, "cpu", small=True))


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_fails_at_the_cells_size(cell, card):
    check(cell, *control(cell, str(card), small=False))
