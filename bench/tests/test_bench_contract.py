"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files that serve it (CPU; run with ``python -m pytest -q
bench/tests``)."""
from __future__ import annotations

import json
import math
import re
import statistics
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(SPEC) == TOP_KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_command_and_paths():
    cmd, paths = SPEC["command"], SPEC["paths"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    for word in cmd:
        if "/" in word:        # a file of the repo the command names
            assert not word.startswith("/") and ".." not in word
            assert any(word.startswith(p + "/") for p in paths), word


def test_run_seconds_fit_the_check_with_24_cells():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def _names(entries):
    return [e["name"] for e in entries]


def test_names_units_and_lines():
    everything = (SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"]
                  + SPEC["per_layer"])
    for e in everything:
        assert NAME.match(e["name"]), e["name"]
    for group in ("configs", "workloads"):
        names = _names(SPEC[group])
        assert len(names) == len(set(names))
    metrics = _names(SPEC["end_to_end"]) + _names(SPEC["per_layer"])
    assert len(metrics) == len(set(metrics))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in SPEC["configs"]:
        assert _line(c["why"]) and _line(c["source"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert _line(w["why"]) and NAME.match(w["traffic"])
        assert NAME.match(w["config"])


def test_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}


def test_counts():
    assert 1 <= len(SPEC["configs"]) <= 24
    assert 1 <= len(SPEC["workloads"]) <= 24
    assert 1 <= len(SPEC["end_to_end"]) <= 16
    assert 1 <= len(SPEC["per_layer"]) <= 128
    four = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in SPEC["workloads"])
    assert len(four) <= max(1, len(SPEC["workloads"]) // 4)


def test_configs_are_used_and_their_files_under_paths():
    used = {w["config"] for w in SPEC["workloads"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]
        for key in ("assumed", "deployment", "resident_bytes", "reference"):
            assert key in body, (c["name"], key)
        assert (ROOT / body["reference"]).is_file()


def test_no_width_is_reduced():
    width = re.compile(r"(_size$|_dim$|_rank$|^d_|intermediate|latent|"
                       r"expansion|per_tok|heads?_)")
    for c in SPEC["configs"]:
        for key in c["reduced"]:
            assert key == "vocab_size" or not width.search(key), key


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in SOURCES_E2E
    assert "setup_s" in _names(SPEC["end_to_end"])


def _reports(cell: str) -> set:
    return {m["name"] for m in SPEC["end_to_end"]
            if cell in m.get("workloads", [cell])}


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    for w in SPEC["workloads"]:
        mine = _reports(w["name"])
        assert "setup_s" in mine and len(mine) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in SPEC["per_layer"])


def test_per_layer_metrics_move_what_their_cells_report():
    cells = set(_names(SPEC["workloads"]))
    layers = {}
    for m in SPEC["per_layer"]:
        assert _line(m["layer"])
        assert m["moves"] in _names(SPEC["end_to_end"])
        assert m["workloads"] and set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert m["moves"] in _reports(cell), (m["name"], cell)
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_shares_of_peaks_are_percent():
    for m in SPEC["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")


PARKED = json.loads((BENCH / "parked.json").read_text())
WITH_PARKED = {k: SPEC[k] + PARKED[k] for k in ("configs", "workloads",
                                                 "end_to_end", "per_layer")}


def test_parked_entries_are_whole_and_apart():
    """Each parked cell comes with its configuration and its own metrics,
    none of whose names BENCHMARK.json uses, so that the entries go back
    as they are."""
    assert set(PARKED) == {"about", "configs", "workloads", "end_to_end",
                           "per_layer"} and PARKED["about"]
    cells = set(_names(PARKED["workloads"]))
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert not set(_names(PARKED[group])) & set(_names(SPEC[group]))
        for e in PARKED[group]:
            assert NAME.match(e["name"]), e["name"]
    assert {w["config"] for w in PARKED["workloads"]} == set(
        _names(PARKED["configs"]))
    for m in PARKED["end_to_end"] + PARKED["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= cells
        assert UNIT.match(m["unit"])
    for m in PARKED["per_layer"]:
        assert m["moves"] in _names(PARKED["end_to_end"])


@pytest.mark.parametrize("cell", _names(WITH_PARKED["workloads"]))
def test_cell_files_exist(cell):
    w = {x["name"]: x for x in WITH_PARKED["workloads"]}[cell]
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    assert (BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
    limits = json.loads((BENCH / "limits" / f"{cell}.json").read_text())
    for name, entry in limits.items():
        assert entry["limit"] > 0, name
        assert entry["lower"] < entry["limit"] < entry["upper"], name
    for m in WITH_PARKED["end_to_end"] + WITH_PARKED["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name'].split('.')[0]}.py").is_file()


def test_the_spread_rule_arithmetic():
    """The bound's spread is Python's quartiles over the median."""
    values = [10.0, 10.1, 10.2, 9.9, 10.05, 10.15]
    q = statistics.quantiles(values, n=4)
    spread = (q[2] - q[0]) / statistics.median(values)
    assert 0 < spread < 0.03 and math.isfinite(spread)
