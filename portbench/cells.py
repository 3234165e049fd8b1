"""Finds a cell's pieces by the names in BENCHMARK.json: its configuration
(the file the entry names), its traffic mix (traffic/<name>.json) and a
reader for each of its metrics (metrics/<name>.py, a module whose
read(record) returns the number or None).  A cell, a configuration, a mix
or a metric is added by adding files and entries; nothing here changes.
"""

import importlib.util
import json
from pathlib import Path


def load_json(path):
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, workload: str) -> bool:
    """A metric without a "workloads" key is read in every cell."""
    return workload in metric.get("workloads", [workload])


def cell(bench_path, workload: str) -> dict:
    """{"name", "chips", "config", "traffic", "end_to_end", "per_layer"} of
    the workload named `workload` in the benchmark file at bench_path; the
    configuration file is read relative to the file's directory, the
    traffic mix from traffic/ beside this module's package directory."""
    bench_path = Path(bench_path)
    bench = load_json(bench_path)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in {bench_path}: "
                       f"{sorted(by_name)}")
    w = by_name[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(bench_path.parent / configs[w["config"]]["file"])
    traffic = load_json(bench_dir(bench_path) / "traffic"
                        / f"{w['traffic']}.json")
    return {"name": workload, "chips": w["chips"], "config": config,
            "traffic": traffic,
            "end_to_end": [m for m in bench["end_to_end"]
                           if applies(m, workload)],
            "per_layer": [m for m in bench["per_layer"]
                          if applies(m, workload)]}


def bench_dir(bench_path) -> Path:
    """The benchmark's folder: the first of the file's paths."""
    bench_path = Path(bench_path)
    return bench_path.parent / load_json(bench_path)["paths"][0]


def reader(bench_path, name: str):
    """The read(record) function of metrics/<name>.py."""
    path = bench_dir(bench_path) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
