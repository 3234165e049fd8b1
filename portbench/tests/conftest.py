"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with one
more cell, added by files alone, that proves the plain layout's 16-step
loop in seconds on the CPU."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

DATA = Path(__file__).resolve().parent / "data"
TINY_CELL = "plain-tiny-eth"


def add_cell(root: Path, config_file: Path, traffic_file: Path, cell: str):
    """Add a configuration, a traffic mix and a cell to the benchmark copy
    at root by their files and entries alone."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    config = json.loads(config_file.read_text())
    traffic = json.loads(traffic_file.read_text())
    shutil.copy(config_file, root / "portbench" / "configs"
                / config_file.name)
    shutil.copy(traffic_file, root / "portbench" / "traffic"
                / traffic_file.name)
    bench["configs"].append({
        "name": config["name"], "source": config["source"],
        "file": f"portbench/configs/{config_file.name}", "reduced": [],
        "why": "test only"})
    bench["workloads"].append({
        "name": cell, "config": config["name"], "traffic": traffic["name"],
        "chips": 1, "why": "test only"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of BENCHMARK.json and portbench/ with the tiny cell added;
    returns the copy's BENCHMARK.json."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    add_cell(root, DATA / "plain-tiny.json", DATA / "tiny.json", TINY_CELL)
    return root / "BENCHMARK.json"


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
