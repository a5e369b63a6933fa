"""Small cells for the CPU tests: the benchmark's own cells with their
configuration cut to a box the CPU steps in seconds."""

from sphbench import harness


def tiny_spec(cell_name: str, per_side: int, **work):
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    _, cell, wl, cfg = harness.load_cell(cell_name)
    cfg = dict(cfg, per_side=per_side)
    wl = dict(wl, **work)
    return bench, cell, wl, cfg


def run_tiny(cell_name, per_side, seed=987654321012, seconds=0.2,
             traced=False, control=False, **work):
    import time
    return harness.run_cell(
        cell_name, seed, seconds, traced, time.perf_counter(), device="cpu",
        control=control, spec=tiny_spec(cell_name, per_side, **work),
        log=lambda *a: None)
