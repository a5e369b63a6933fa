"""The benchmark's files: every cell, configuration and metric found by
name, and every name, unit and text within the contract's characters."""

import json
import re

import pytest

from sphbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["sphbench"]
    assert not BENCH["paths"][0].endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_found_by_name(cell):
    _, entry, work, cfg = harness.load_cell(cell["name"])
    assert entry is not None and work["config"] == cell["config"]
    assert cfg["name"] == cell["config"]
    assert cell["chips"] in (1, 4)
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]
    # the check's limits cover exactly the numbers it computes
    expect = {"start_err", "tags_lost", "mass_drift", "x_err", "v_err",
              "e_err", "rho_err", "f_err", "drho_err", "de_err"}
    if cfg.get("phase_change"):
        expect |= {"m_err", "pc_events_off", "pc_err", "pc_x_err"}
    assert set(work["correct"]) == expect


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_found_by_name(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert 1 <= len(conf["why"]) <= 200
    assert conf["file"] == f"sphbench/configs/{conf['name']}.json"
    cfg = harness.load_json(harness.ROOT / conf["file"])
    assert cfg["name"] == conf["name"]
    assert cfg["reduced"] == conf["reduced"] == []
    assert 1 <= len(conf["source"]) <= 200
    assert any(c["config"] == conf["name"] for c in BENCH["workloads"])


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_found_by_name(metric):
    mod = harness.metric_reader(metric["name"])
    assert mod.NAME == metric["name"]
    assert mod.UNIT == metric["unit"]
    assert mod.SOURCE == metric["source"]
    if metric in BENCH["per_layer"]:
        assert mod.LAYER == metric["layer"]
        assert mod.MOVES == metric["moves"]
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0 < metric["bound"] <= 0.25
    assert callable(mod.read)


def test_every_reader_has_an_entry():
    files = {p.name[:-3] for p in (harness.HERE / "metrics").glob("*.py")
             if not p.name.startswith("_")}
    assert files == {m["name"] for m in METRICS}


def test_names_and_units():
    names = [m["name"] for m in METRICS] + [
        c["name"] for c in BENCH["configs"]] + [
        w["name"] for w in BENCH["workloads"]] + [
        w["config"] for w in BENCH["workloads"]] + [
        w["traffic"] for w in BENCH["workloads"]]
    for name in names:
        assert NAME.match(name), name
    for group in (METRICS, BENCH["configs"], BENCH["workloads"]):
        assert len({g["name"] for g in group}) == len(group)
    for m in METRICS:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_four_chip_cells():
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)


def test_every_cell_reports_setup_and_two_more():
    for w in BENCH["workloads"]:
        e2e = harness.cell_metrics(BENCH, w["name"], "end_to_end")
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        layer = harness.cell_metrics(BENCH, w["name"], "per_layer")
        assert layer
        for m in layer:
            assert m["moves"] in names, (w["name"], m["name"])


def test_run_seconds_fit_the_check():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
