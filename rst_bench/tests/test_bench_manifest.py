"""BENCHMARK.json against the rules of its format, and every name in it against
the files that the harness finds by that name."""

import importlib
import json
import re

import pytest

from rst_bench import run, yardstick

BENCH = json.loads((yardstick.ROOT.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", *KEYS}
    assert BENCH["paths"] == ["rst_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_names_and_units(section):
    entries = BENCH[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]


def test_cells_name_their_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for cell in BENCH["workloads"]:
        assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
        assert cell["chips"] in (1, 4)
        cfg = yardstick.load_config(configs[cell["config"]]["file"])
        assert cfg["name"] == cell["config"]
        traffic = json.loads((yardstick.ROOT / "traffic" / f"{cell['traffic']}.json").read_text())
        importlib.import_module(f"rst_bench.drivers.{traffic['driver']}")
    assert {c["config"] for c in BENCH["workloads"]} == set(configs)


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_every_per_layer_metric_has_a_reader_and_its_moves_in_each_cell():
    cells = [c["name"] for c in BENCH["workloads"]]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        reader = importlib.import_module("rst_bench.metrics." + m["name"].replace(".", "_"))
        assert callable(reader.read)
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert run.in_cell(moved, cell), (m["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for cell in (c["name"] for c in BENCH["workloads"]):
        e2e = [m["name"] for m in BENCH["end_to_end"] if run.in_cell(m, cell)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(run.in_cell(m, cell) for m in BENCH["per_layer"])


def test_layers_are_one_name_each():
    for m in BENCH["per_layer"]:
        assert m["layer"] == m["layer"].strip() and "\n" not in m["layer"]
