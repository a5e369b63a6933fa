"""A configuration brings its own scene, box and reference as files that
the harness finds by name, and the default's readings stay as they were:

- the default scene's inputs of ``boiling_4m`` at its full size, byte for
  byte, and the pair counts in its box, against ``tiny_tables.json`` (the
  check's numbers of the tiny run are held in test_sphbench_faults.py);
- a second configuration added by files alone under this folder
  (``configs/slab.json``, ``workloads/slab.bricks2.json``,
  ``scenes/slab.py``, ``reference/slab.py``): the bench physics in a 2:1:1
  box periodic along x and y only, with no phase change, built from an
  input script through the program's script layer and run through
  ``harness.run_cell`` on the CPU."""

import hashlib

import numpy as np
import pytest
import torch

from _tiny import TESTS, freeze_bricks, run_slab
from sphbench import harness

TABLES = harness.load_json(TESTS / "tiny_tables.json")
BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
CONFIGS = [(harness.HERE, harness.load_json(harness.ROOT / c["file"]))
           for c in BENCH["configs"]] + [
    (TESTS, harness.load_json(p))
    for p in sorted(TESTS.glob("configs/*.json"))]


@pytest.mark.parametrize("root,cfg", CONFIGS, ids=lambda v: (
    v["name"] if isinstance(v, dict) else v.name))
def test_scene_and_reference_found_by_name(root, cfg):
    scene = harness.load_part(
        "scenes", cfg.get("scene", harness.DEFAULT_SCENE), root)
    ref = harness.load_part(
        "reference", cfg.get("reference", harness.DEFAULT_REFERENCE), root)
    for name in ("make_inputs", "build_sim", "box"):
        assert callable(getattr(scene, name)), name
    assert {"liquid", "vapour"} <= set(scene.TYPES)
    box = scene.box(cfg)
    assert len(box.lo) == len(box.hi) == len(box.periodic) == 3
    assert all(h > lo for lo, h in zip(box.lo, box.hi))
    for name in ("Physics", "step", "rule"):
        assert callable(getattr(ref, name)), name


@pytest.mark.parametrize("seed", sorted(TABLES["inputs"]))
def test_default_scene_inputs_as_recorded(seed):
    _, _, _, cfg = harness.load_cell("boiling_4m.bricks4_card1")
    scene = harness.load_part("scenes", harness.DEFAULT_SCENE)
    inputs = scene.make_inputs(cfg, int(seed))
    got = {k: hashlib.sha256(v.tobytes()).hexdigest()
           for k, v in inputs.items()}
    assert got == TABLES["inputs"][seed]


class _Positions:
    """``pair_counts``'s view of a simulation: the owned particles."""

    mesh = None
    device = torch.device("cpu")

    def __init__(self, x, typ):
        self.fields = dict(x=x, type=typ)

    def get(self, field):
        return self.fields[field]


def test_default_pair_counts_as_recorded():
    """The tiny run's inputs moved by 3 v, some past every face."""
    _, _, _, cfg = harness.load_cell("boiling_4m.bricks4_card1")
    cfg = dict(cfg, per_side=24)
    scene = harness.load_part("scenes", harness.DEFAULT_SCENE)
    inputs = scene.make_inputs(cfg, 987654321012)
    x = (inputs["x"] + np.float32(3.0) * inputs["v"]).astype(np.float32)
    assert (x < 0).any() and (x >= 24.0).any()
    got = harness.pair_counts(_Positions(x, inputs["type"]),
                              scene.box(cfg), cfg["h"])
    assert got == TABLES["pair_counts"]


@pytest.mark.parametrize("control", [False, True])
def test_slab_added_by_files_alone(control):
    r, work = run_slab(control=control)
    assert r["correct"] != control, r["checks"]
    # no phase change: the check compares no number of a rule
    assert set(r["checks"]) == set(work["correct"])


def test_slab_step_that_returns_its_state_unchanged(monkeypatch):
    freeze_bricks(monkeypatch)
    r, _ = run_slab()
    assert not r["correct"]
    assert r["checks"]["x_err"]["value"] > r["checks"]["x_err"]["limit"]
