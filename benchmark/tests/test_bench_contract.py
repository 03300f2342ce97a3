"""``BENCHMARK.json`` against the benchmark's contract, and every file a
cell names found by its name."""

from __future__ import annotations

import re

import pytest

from benchmark import common

BENCH = common.load_json(common.ROOT / "BENCHMARK.json")
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
CELLS = [w["name"] for w in BENCH["workloads"]]
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    entry_keys = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
    }
    for group, keys in entry_keys.items():
        for e in BENCH[group]:
            extra = {"workloads"} if group in ("end_to_end",
                                               "per_layer") else set()
            assert keys <= set(e) <= keys | extra, (group, e["name"])


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            names.append(e["name"])
            assert NAME.fullmatch(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.fullmatch(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer"):
                if key in e:
                    assert _line(e[key]), (e["name"], key)
    for w in BENCH["workloads"]:
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
    for c in BENCH["configs"]:
        assert _line(c["source"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[group]}) == len(BENCH[group])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for word in BENCH["command"]:
        assert _line(word)
    assert len(BENCH["command"]) <= 32
    assert all(PATH.fullmatch(p) and ".." not in p for p in BENCH["paths"])
    assert len(str(BENCH).encode()) < 64 * 1024


def test_sizes_and_bounds():
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = common.load_cell(name)
    config = next(c for c in BENCH["configs"] if c["name"] == cell.entry[
        "config"])
    assert any(config["file"].startswith(p + "/") for p in BENCH["paths"])
    assert common.generator(cell.traffic["kind"]).run
    for key in ("config", "traffic", "chips", "why"):
        assert cell.workload[key] == cell.entry[key], key
    assert cell.limits
    for key in config["reduced"]:
        assert key in cell.config, key
    for m in cell.per_layer:
        reader = common.metric_reader(m["name"])
        assert (reader.LAYER, reader.UNIT, reader.MOVES, reader.SOURCE) == (
            m["layer"], m["unit"], m["moves"], m["source"]), m["name"]
        assert callable(reader.read)


@pytest.mark.parametrize("name", CELLS)
def test_cell_reports(name):
    cell = common.load_cell(name)
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    # each per-layer metric moves an end-to-end metric the cell reports
    for m in cell.per_layer:
        assert m["moves"] in reported, (m["name"], m["moves"])


def test_every_config_used_and_files_distinct():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_command_names_only_the_benchmarks_files():
    for word in BENCH["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
