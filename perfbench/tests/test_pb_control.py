"""The control fails on the card: the reference in TF32 in the program's
place, at each cell's own sizes, on three seeds, reads over a limit of the
cell on every seed."""

import pytest

from perfbench.control import control_readings

CELLS = ["emulator32.serve", "emulator32.train", "quickstart5.train"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(manifest, cuda, cell):
    limits = manifest.limits(cell)
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        gaps = control_readings(manifest, cell, seed, cuda)
        assert any(gaps[k] > limits[k] for k in limits), (seed, gaps, limits)
