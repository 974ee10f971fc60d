"""The control, the plain reference in the port's place at TF32 (the
nearest precision below the configurations' float32), comes out not
correct: on a small scene on the CPU (40 cameras, 33,000 observations),
and at each cell's own size on the card (``cuda``)."""

import pytest
import torch

import _tiny
from portbench import bench
from portbench.control import control_gaps

CELLS = ["venice1778.cold", "dubrovnik356.cold"]
SEEDS = [2 ** 31 + 12345, 3_000_000_019, 4_100_000_003]


def _fails(gaps, limits):
    return any(not gaps[n] <= limits[n] for n in limits)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_a_tiny_scene(tmp_path, cell):
    root = _tiny.make_root(tmp_path, _tiny.SMALL)
    _, _, config, traffic, _, _ = bench.find_cell(root, cell)
    gaps = control_gaps(config, traffic, _tiny.SEED, "cpu")
    assert _fails(gaps, config["check_limits"]), gaps


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cell_size(card, cell, seed):
    _, _, config, traffic, _, _ = bench.find_cell(_tiny.ROOT, cell)
    gaps = control_gaps(config, traffic, seed, card)
    print(cell, seed, gaps)
    assert _fails(gaps, config["check_limits"]), gaps
