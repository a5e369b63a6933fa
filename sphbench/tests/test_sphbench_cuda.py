"""On the card (``-m cuda``; skipped elsewhere): the control and the
sound program through the whole harness, at a size a test run holds: the
benchmark's cell cut to 48^3, and the tests' slab (a configuration added
as files alone). The cells' own sizes are read by ``python3 -m
sphbench.run ... --control`` (see the README)."""

import time

import pytest
import torch

from _tiny import run_slab, tiny_spec
from sphbench import harness


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _run(card, cell, per_side, control, seed, **work):
    return harness.run_cell(
        cell, seed, 1.0, False, time.perf_counter(), device=card,
        control=control, spec=tiny_spec(cell, per_side, **work),
        log=lambda *a: None)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [31, 4294967311, 2 ** 31 + 5])
@pytest.mark.parametrize("cell", ["boiling_4m.bricks4_card1"])
def test_program_correct_and_control_not(card, cell, seed):
    prog = _run(card, cell, 48, False, seed)
    assert prog["correct"], prog["checks"]
    ctrl = _run(card, cell, 48, True, seed)
    assert not ctrl["correct"], ctrl["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [31, 4294967311])
def test_slab_correct_and_control_not(card, seed):
    prog, _ = run_slab(seed, device=card, seconds=1.0)
    assert prog["correct"], prog["checks"]
    ctrl, _ = run_slab(seed, control=True, device=card, seconds=1.0)
    assert not ctrl["correct"], ctrl["checks"]
