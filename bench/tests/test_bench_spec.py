"""``BENCHMARK.json`` and the files it names: the benchmark's contract, as
far as it can be read without running a cell."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys_and_size():
    assert set(BENCH) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
            assert (ROOT / word).is_file()


def test_run_seconds_fit_the_check_with_every_cell():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    cells = 24
    assert (2 + 14 * cells) * (s + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
    assert len(c["reduced"]) <= 16
    assert all(NAME.match(k) for k in c["reduced"])
    assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
    body = json.loads((ROOT / c["file"]).read_text())
    assert body["name"] == c["name"] and body["source"] == c["source"]
    assert body["reduced"] == c["reduced"]
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_entry_resolves(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4) and _line(w["why"])
    assert w["config"] in {c["name"] for c in BENCH["configs"]}
    body = json.loads((ROOT / "bench" / "workloads"
                       / f"{w['name']}.json").read_text())
    assert body["config"] == w["config"]
    assert (ROOT / "bench" / "configs" / f"{body['config']}.json").is_file()
    assert (ROOT / "bench" / "drivers" / f"{body['driver']}.py").is_file()
    assert body["limits"] and all(v > 0 for v in body["limits"].values())


def test_names_are_unique_and_pairs_appear_once():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_entry(m):
    e2e = m in BENCH["end_to_end"]
    base = {"name", "unit", "better", "source"}
    allowed = base | ({"bound"} if e2e else {"layer", "moves"}) \
        | {"workloads"}
    assert base <= set(m) <= allowed
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if e2e:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and "bound" not in m


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_moves_names_an_end_to_end_metric_of_each_of_its_cells(m):
    e2e = {x["name"]: x for x in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    cells = m.get("workloads", [w["name"] for w in BENCH["workloads"]])
    assert all(_reports(e2e[m["moves"]], c) for c in cells)


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(w):
    e2e = [m["name"] for m in BENCH["end_to_end"] if _reports(m, w["name"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(_reports(m, w["name"]) for m in BENCH["per_layer"])


def test_setup_bound_and_layer_names():
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25
    layers = {m["layer"] for m in BENCH["per_layer"]}
    text = (ROOT / "PERF.md").read_text()
    assert all(layer in text for layer in layers)


def test_files_under_paths_are_named_from_name_characters():
    for p in BENCH["paths"]:
        for f in (ROOT / p).rglob("*"):
            if f.is_file() and "__pycache__" not in f.parts:
                rel = f.relative_to(ROOT).as_posix()
                assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
