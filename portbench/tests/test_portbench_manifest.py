"""BENCHMARK.json against the contract's limits, and the harness finding a
cell's pieces by name."""

import json
import re
import shutil

import pytest

from portbench import cells
from portbench.tests.conftest import DATA, ROOT, TINY_CELL, add_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
KEYS = {"top": {"command", "paths", "run_seconds", "configs", "workloads",
                "end_to_end", "per_layer"},
        "config": {"name", "source", "file", "reduced", "why"},
        "workload": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer",
                      "moves"}}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_paths_and_command():
    assert set(BENCH) == KEYS["top"]
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    assert len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (ROOT / BENCH["command"][1]).is_file()


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_entries_keys_and_names(section):
    kind = {"configs": "config", "workloads": "workload"}.get(section,
                                                             section)
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        extra = set(e) - KEYS[kind]
        assert extra <= ({"workloads"} if kind in ("end_to_end", "per_layer")
                         else set()), extra
        assert KEYS[kind] <= set(e)
        assert NAME.fullmatch(e["name"])
        for key in ("why", "layer", "source"):
            if key in e and kind not in ("end_to_end", "per_layer"):
                assert _line(e[key])
        if kind in ("end_to_end", "per_layer"):
            assert UNIT.fullmatch(e["unit"])
            assert e["better"] in ("lower", "higher")
        if kind == "per_layer":
            assert _line(e["layer"])
            assert e["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert e["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        if kind == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace")
            assert 0.01 <= e["bound"] <= 0.25
        if kind == "workload":
            assert NAME.fullmatch(e["config"])
            assert NAME.fullmatch(e["traffic"]) and e["chips"] in (1, 4)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    workloads = [w["name"] for w in BENCH["workloads"]]
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(workloads)
    assert {c["name"] for c in BENCH["configs"]} == \
        {w["config"] for w in BENCH["workloads"]}
    metrics = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", [])) <= set(workloads)
    for w in workloads:
        spec = cells.cell(ROOT / "BENCHMARK.json", w)
        e2e = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2 and spec["per_layer"]
    assert len(metrics) == len(BENCH["end_to_end"] + BENCH["per_layer"])


@pytest.mark.parametrize("workload",
                         [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files(workload):
    spec = cells.cell(ROOT / "BENCHMARK.json", workload)
    config, traffic = spec["config"], spec["traffic"]
    entry = next(c for c in BENCH["configs"] if c["name"] == config["name"])
    assert entry["reduced"] == config["reduced"]
    assert set(config["reduced"]) <= set(config)
    assert entry["source"] == config["source"]
    for key in ("layout", "scheme", "n_steps", "security_bits",
                "jobs_in_pool", "proofs_checked"):
        assert key in config
    assert set(traffic["options"]) == {
        "num_queries", "lde_blowup_factor", "proof_of_work_bits",
        "fri_folding_factor", "fri_max_remainder_coeffs"}
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(cells.reader(ROOT / "BENCHMARK.json", m["name"]))


def test_files_under_paths_are_named_from_name_characters():
    for p in (ROOT / "portbench").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert PATH.fullmatch(rel), rel


def test_a_full_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_the_file_is_small():
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_a_cell_added_by_files_alone_is_found(bench_copy):
    root = bench_copy.parent
    spec = cells.cell(bench_copy, TINY_CELL)
    assert spec["config"]["layout"] == "plain"
    assert spec["traffic"]["options"]["num_queries"] == 4
    # a further metric by its file and entry alone
    metric = root / "portbench" / "metrics" / "proofs_per_window.py"
    metric.write_text("def read(record):\n"
                      "    return len(record['window']['proofs'])\n")
    bench = json.loads(bench_copy.read_text())
    bench["per_layer"].append({
        "name": "proofs_per_window", "unit": "proofs", "better": "higher",
        "source": "host_clock", "layer": "loader", "moves": "prove_s",
        "workloads": [TINY_CELL]})
    bench_copy.write_text(json.dumps(bench))
    spec = cells.cell(bench_copy, TINY_CELL)
    assert "proofs_per_window" in [m["name"] for m in spec["per_layer"]]
    read = cells.reader(bench_copy, "proofs_per_window")
    assert read({"window": {"proofs": [1, 2, 3]}}) == 3
    assert TINY_CELL not in [m["name"] for m in cells.cell(
        bench_copy, "recursive-cairo-b2")["per_layer"]]


def test_the_test_cell_is_not_in_the_benchmark(tmp_path):
    assert TINY_CELL not in [w["name"] for w in BENCH["workloads"]]
    root = tmp_path / "c"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    add_cell(root, DATA / "plain-tiny.json", DATA / "tiny.json", "x")
    with pytest.raises(KeyError):
        cells.cell(ROOT / "BENCHMARK.json", "x")
