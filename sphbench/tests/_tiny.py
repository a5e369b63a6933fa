"""Small cells for the CPU tests: the benchmark's own cells with their
configuration cut to a box the CPU steps in seconds, and the tests' own
configuration ``slab``, added as files under this folder."""

import time
from pathlib import Path

from sphbench import harness

TESTS = Path(__file__).resolve().parent
SLAB_CELL = dict(name="slab.bricks2", config="slab", traffic="bricks2",
                 chips=1, why="the tests' slab: boundary p p f, in two bricks")


def tiny_spec(cell_name: str, per_side: int, **work):
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    _, cell, wl, cfg = harness.load_cell(cell_name)
    cfg = dict(cfg, per_side=per_side)
    wl = dict(wl, **work)
    return bench, cell, wl, cfg


def run_tiny(cell_name, per_side, seed=987654321012, seconds=0.2,
             traced=False, control=False, **work):
    return harness.run_cell(
        cell_name, seed, seconds, traced, time.perf_counter(), device="cpu",
        control=control, spec=tiny_spec(cell_name, per_side, **work),
        log=lambda *a: None)


def run_slab(seed=987654321012, control=False, device="cpu", seconds=0.0):
    """The slab's cell through ``run_cell``, its files found under this
    folder; returns (result, workload)."""
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cfg = harness.load_json(TESTS / "configs" / "slab.json")
    work = harness.load_json(TESTS / "workloads" / "slab.bricks2.json")
    return harness.run_cell(
        SLAB_CELL["name"], seed, seconds, False, time.perf_counter(),
        device=device, control=control, spec=(bench, SLAB_CELL, work, cfg),
        parts=TESTS, log=lambda *a: None), work


def freeze_bricks(monkeypatch):
    """The bricks' step loop broken underneath: it returns its state
    unchanged."""
    from tpusph_torch.dist import DistRunner

    def frozen(self, state, tabs, dt, nsteps, aux, istep0=0, every=0,
               callback=None, phase_timer=False):
        self.ok_steps = nsteps
        if callback is not None:
            callback(state, istep0 + nsteps, aux)
        return state, aux

    monkeypatch.setattr(DistRunner, "run", frozen)
