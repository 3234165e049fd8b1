"""The recorder (sandstorm_tpu_torch/telemetry.py) on a tiny CPU prove: every
span closed and nested in its parent, one request from the claim through
the serialization, the phase spans equal to LAST_PHASES, the base columns'
upload counted; no profiler range without a profiler, and under one every
span a record_function range on the same clock; the store's bound; the
benchmark's six readers of the recorder in the tiny cell.  One case needs
a card (marker `cuda`): a recursive prove's spans and launch counters.

    python3 -m pytest --noconftest tests/test_torch_telemetry.py -m cuda
"""

import collections
import json
import os
import shutil
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from sandstorm_tpu_torch import _native, claims, telemetry  # noqa: E402
from sandstorm_tpu_torch.stark import ark, prover  # noqa: E402

READERS = ("trace_decode_s", "trace_builtins_s", "trace_columns_s", "h2d_s",
           "h2d_mib", "host_blocked_s")


def _prove(claim, witness, options=None):
    """claim -> trace -> prove -> bytes, as the CLI goes: (request, proof,
    the trace's canonical base columns)."""
    trace = claim.generate_trace(witness)
    proof = prover.prove(claim.F, claim.air_config, trace, options,
                         scheme=claim.scheme)
    ark.serialize_proof(proof)
    return telemetry.get(trace.request), proof, trace.base_cols_canonical


@pytest.fixture(scope="module")
def tiny():
    """One tiny CPU prove of the plain layout and its phases."""
    claim, witness = claims.loop_claim(16, torch.device("cpu"))
    request, proof, base = _prove(claim, witness)
    return {"claim": claim, "request": request, "proof": proof,
            "base": base, "phases": list(prover.LAST_PHASES)}


def test_every_span_is_closed_and_inside_its_parent(tiny):
    spans = tiny["request"].spans
    assert len(spans) > 50
    for s in spans:
        assert s.start is not None and s.end is not None, s.name
        assert s.start <= s.end, s.name
        assert s.request == tiny["request"].id
        if s.parent is not None:
            assert s.parent in spans, s.name
            assert s.parent.start <= s.start and s.end <= s.parent.end, \
                (s.name, s.parent.name)


def test_one_request_runs_from_the_claim_through_the_proof(tiny):
    req = tiny["request"]
    assert req.id == tiny["proof"].request
    roots = [s.name for s in req.spans if s.parent is None]
    assert roots == ["claim", "trace.build", "prove", "serialize"]
    build = req.find("trace.build")[0]
    assert [c.name for c in req.children(build)][:2] == ["trace.decode",
                                                         "trace.cpu"]
    # a second trace of the claim starts a request of its own
    assert tiny["claim"].request is None


def test_the_phase_spans_are_last_phases(tiny):
    req = tiny["request"]
    phases = req.children(req.find("prove")[0])
    assert [(s.name, s.seconds) for s in phases] == tiny["phases"]
    assert [label for label, _ in tiny["phases"]] == [
        "scheme tables", "base columns interpolated + extended",
        "base commit", "extension columns built",
        "extension columns interpolated + extended", "extension commit",
        "constraint evaluation",
        "composition interpolated + split + extended", "composition commit",
        "OODS openings", "DEEP composition", "FRI layers", "FRI remainder",
        "PoW + queries", "query assembly"]
    assert len(req.find("fri.layer")) == len(tiny["proof"].fri_layers)


def test_the_base_columns_upload_counts_their_bytes(tiny):
    (upload,) = tiny["request"].find("h2d.base_columns")
    assert upload.counts["h2d_bytes"] == sum(
        c.nbytes for c in tiny["base"].values())
    total = tiny["request"].counts()
    assert total["h2d_bytes"] >= upload.counts["h2d_bytes"]
    assert total["d2h_bytes"] > 0


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_the_pinned_stage_counts_on_the_card_only(device):
    """upload_base_columns counts the columns' bytes as h2d_bytes on every
    device and as h2d_pinned_bytes only on the card's pinned route."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    from sandstorm_tpu_torch.fields.fp252 import Fp252
    from sandstorm_tpu_torch.layouts.utils import upload_base_columns
    rng = np.random.default_rng(24)
    cols = {i: rng.integers(0, 1 << 59, size=(1 << 10, 4), dtype=np.uint64)
            for i in range(7)}
    rid = telemetry.new_request()
    with telemetry.span("upload", request=rid):
        upload_base_columns(Fp252, cols, torch.device(device))
    counts = collections.Counter()
    for s in telemetry.get(rid).find("h2d.base_columns"):
        counts.update(s.counts)
    nbytes = sum(c.nbytes for c in cols.values())
    assert counts["h2d_bytes"] == nbytes
    assert counts["h2d_pinned_bytes"] == (nbytes if device == "cuda" else 0)


def test_a_loaded_bundle_joins_the_claims_request(tmp_path):
    from sandstorm_tpu_torch import examples
    from sandstorm_tpu_torch.tools import make_artifacts
    make_artifacts.loop_bundle(str(tmp_path), 16)
    program, pub, witness = examples.load_artifacts(
        tmp_path / "program.json", tmp_path / "air-public-input.json",
        tmp_path / "air-private-input.json")
    loaded = pub.request
    claim = claims.CairoClaim(program, pub, device="cpu")
    assert claim.request == loaded and pub.request is None
    req = telemetry.get(loaded)
    assert [s.name for s in req.spans] == ["load", "claim"]


def test_no_profiler_range_without_a_profiler(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(telemetry, "record_function", Counting)
    claim, witness = claims.loop_claim(16, torch.device("cpu"))
    request, _, _ = _prove(claim, witness)
    assert len(request.spans) > 50 and entered == []


def test_under_a_profiler_every_span_is_a_range_on_its_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        claim, witness = claims.loop_claim(16, torch.device("cpu"))
        request, _, _ = _prove(claim, witness)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    names = {s.name for s in request.spans}
    ranges = sorted((e for e in events if e.get("ph") == "X"
                     and e.get("cat") == "user_annotation"
                     and e.get("name") in names), key=lambda e: e["ts"])
    # the k-th span of a name is the k-th range of that name
    by_name = {}
    for e in ranges:
        by_name.setdefault(e["name"], []).append(e)
    match = {}
    for name in names:
        spans = [s for s in request.spans if s.name == name]
        assert len(by_name.get(name, [])) == len(spans), name
        match.update({id(s): e for s, e in zip(spans, by_name[name])})
    # a span's clocks are read outside its range, so after one offset each
    # range lies within its span, to 1 ms
    (prove,) = request.find("prove")
    offset = match[id(prove)]["ts"] - prove.start / 1e3       # us
    for s in request.spans:
        e = match[id(s)]
        assert s.start / 1e3 + offset - 1e3 <= e["ts"], s.name
        assert e["ts"] + e["dur"] <= s.end / 1e3 + offset + 1e3, s.name
        if s.parent is not None:
            p = match[id(s.parent)]
            assert p["ts"] <= e["ts"] and \
                e["ts"] + e["dur"] <= p["ts"] + p["dur"], (s.name,
                                                          s.parent.name)


def test_the_store_keeps_the_last_256_requests():
    first = telemetry.new_request()
    ids = [telemetry.new_request() for _ in range(telemetry.MAX_REQUESTS)]
    kept = [r.id for r in telemetry.requests()]
    assert len(kept) == telemetry.MAX_REQUESTS == 256
    assert kept == ids and telemetry.get(first) is None
    with telemetry.span("root", request=ids[-1]) as root:
        with telemetry.span("child"):
            telemetry.count("things", 3)
        telemetry.count("things", 1)
    with telemetry.span("orphan"):
        telemetry.count("things", 5)
    req = telemetry.get(ids[-1])
    assert [s.name for s in req.spans] == ["root", "child"]
    assert req.spans[1].parent is root and req.counts()["things"] == 4


def test_a_tally_charges_the_open_span():
    rid = telemetry.new_request()
    before = _native.LAUNCHES["telemetry_test"]
    with telemetry.span("root", request=rid):
        _native.LAUNCHES.add("telemetry_test", 2)
    assert _native.LAUNCHES["telemetry_test"] == before + 2
    assert telemetry.get(rid).counts()["launches.telemetry_test"] == 2
    _native.LAUNCHES.pop("telemetry_test")


def test_the_tiny_cell_reports_the_six_readers(tmp_path, monkeypatch):
    from portbench import cells, run
    from portbench.tests.conftest import DATA, TINY_CELL, add_cell
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    add_cell(root, DATA / "plain-tiny.json", DATA / "tiny.json", TINY_CELL)
    records = []
    reader = cells.reader

    def spy(bench_path, name):
        read = reader(bench_path, name)

        def wrapped(record):
            records.append(record)
            return read(record)
        return wrapped

    monkeypatch.setattr(run.cells, "reader", spy)
    # the run's profiled proofs are not read here: on the CPU the profiler
    # records every operator (a gigabyte of trace for the tiny cell), and
    # the readers of a device trace read nothing from the CPU's
    monkeypatch.setattr(run, "profile_proofs", lambda *a: {
        "device": [], "spans": [], "phases": [], "proofs": 0,
        "trace_bytes": 0, "start_us": 0.0, "wall_us": 1.0})
    result = run.run_cell(root / "BENCHMARK.json", TINY_CELL, 2 ** 31 + 23,
                          0.5, 1, torch.device("cpu"),
                          t_process=time.perf_counter())
    assert result["correct"] is True
    got = result["metrics"]
    assert set(READERS) <= set(got)
    window = records[0]["window"]
    proofs = telemetry.proofs_between(window["start"], window["end"])
    assert len(proofs) == len(window["proofs"])
    build = sum(r.seconds("trace.build") for r in proofs) / len(proofs)
    parts = sum(got[m]["value"] for m in READERS[:3])
    assert parts == pytest.approx(build, rel=1e-9)
    assert got["h2d_mib"]["value"] > 0 and got["h2d_s"]["value"] > 0
    assert got["host_blocked_s"]["value"] > 0


@pytest.mark.cuda
def test_a_recursive_prove_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    dev = torch.device("cuda", 0)
    claim, witness = claims.recursive_loop_claim(16384, dev)
    _prove(claims.recursive_loop_claim(16384, dev)[0], witness)  # warm-up
    before = dict(_native.LAUNCHES)
    request, _, _ = _prove(claim, witness)
    after = dict(_native.LAUNCHES)
    for s in request.spans:
        assert s.end is not None and s.start <= s.end, s.name
        if s.parent is not None:
            assert s.parent.start <= s.start and s.end <= s.parent.end
    launched = {k: v - before.get(k, 0) for k, v in after.items()
                if v != before.get(k, 0)}
    counted = {k[len("launches."):]: v for k, v in request.counts().items()
               if k.startswith("launches.")}
    assert counted == launched and sum(counted.values()) > 100
    assert request.find("sync.phase")
    assert request.find("merkle.pedersen_device")
