"""The benchmark's arithmetic: the window, the busy union,
the phases on the profiler's clock, the LDE's least time, and the metric
readers on a record made by hand."""

import pytest

from portbench import cells, yardstick
from portbench.tests.conftest import ROOT

BENCH = ROOT / "BENCHMARK.json"


def test_the_window_is_stretched_to_whole_proofs():
    # proofs of 4 s in a 10 s window: the third ends at 12 s, and the
    # window with it
    starts = [100.0, 104.0, 108.0]
    end = starts[-1] + 4.0
    assert yardstick.mean_seconds(starts[0], end, 3) == pytest.approx(4.0)
    with pytest.raises(ValueError):
        yardstick.mean_seconds(0.0, 1.0, 0)


def _ev(ts, dur, cat="kernel", name="k"):
    return {"ph": "X", "cat": cat, "ts": ts, "dur": dur, "name": name}


def test_busy_union_merges_overlaps_and_keeps_gaps():
    events = [_ev(0, 10), _ev(5, 10), _ev(20, 5), _ev(24, 1, "gpu_memcpy"),
              _ev(30, 0)]
    assert yardstick.busy_intervals(events) == [[0, 15], [20, 25],
                                                [30, 30]]
    assert yardstick.busy_ms(events) == pytest.approx(20 / 1e3)
    busy = yardstick.busy_intervals(events)
    assert yardstick.busy_ms_within(busy, 10, 22) == pytest.approx(7 / 1e3)
    assert yardstick.idle_gaps(busy, 0, 40) == [(15, 5), (25, 5), (30, 10)]
    assert yardstick.idle_gaps(busy, 12, 18) == [(15, 3)]


def test_device_events_and_sums_by_kernel():
    events = [_ev(0, 1000, name="void ntt_leaf_kernel<3, true>(...)"),
              _ev(0, 500, "gpu_memcpy", "Memcpy HtoD"),
              _ev(0, 250, "gpu_memset", "Memset"),
              _ev(0, 2000, "cpu_op", "aten::add"),
              {"ph": "i", "cat": "kernel", "ts": 0, "name": "x"}]
    device = yardstick.device_events(events)
    assert len(device) == 3
    by = yardstick.device_ms_by_kernel(device)
    assert by == {"ntt_leaf_fused": (1.0, 1), "gpu_memcpy": (0.5, 1),
                  "gpu_memset": (0.25, 1)}


def test_phases_on_the_profiler_clock():
    phases = [["a", 0.5], ["b", 0.25], ["a", 0.125]]
    assert yardstick.phase_intervals(1000.0, phases) == [
        ("a", 1000.0, 501000.0), ("b", 501000.0, 751000.0),
        ("a", 751000.0, 876000.0)]
    assert yardstick.phase_sum({"phases": phases}, ["a"]) == 0.625
    with pytest.raises(KeyError):
        yardstick.phase_sum({"phases": phases}, ["c"])


def test_lde_least_time_from_the_shapes():
    n, b = 1 << 21, 2
    # (1 + b) transforms of n points, n/2 log2 n butterflies each, a column
    assert yardstick.lde_products(n, b, 1) == 3 * (n // 2) * 21
    assert yardstick.lde_bytes(n, b, 1) == 3 * n * 32
    sms, clock = 132, 1980e6
    mads = yardstick.lde_products(n, b, 10) * 128
    want = mads / (64 * sms * clock)
    assert yardstick.lde_least_s(n, b, 10, sms, clock) == pytest.approx(want)
    assert 5.0e-3 < want < 5.2e-3
    # a tiny transform is bound by its bytes when the rate is huge
    assert yardstick.lde_least_s(16, 2, 1, 10 ** 9, clock) == \
        pytest.approx(3 * 16 * 32 / 3.35e12)


def _record(profile=True):
    phases = [["scheme tables", 0.0],
              ["base columns interpolated + extended", 0.010],
              ["base commit", 0.002],
              ["extension columns built", 0.001],
              ["extension columns interpolated + extended", 0.004],
              ["extension commit", 0.002],
              ["constraint evaluation", 0.003],
              ["composition interpolated + split + extended", 0.001],
              ["composition commit", 0.002],
              ["OODS openings", 0.005], ["DEEP composition", 0.001],
              ["FRI layers", 0.004], ["FRI remainder", 0.001],
              ["PoW + queries", 0.001], ["query assembly", 0.003]]
    proofs = [{"wall_s": w, "load_s": 0.01 * w, "trace_build_s": 0.1 * w,
               "phases": phases} for w in (1.0, 2.0, 3.0)]
    rec = {"setup_s": 12.5, "peak_bytes": 3 * 2 ** 30,
           "config": {"layout": "recursive", "n_steps": 16384},
           "traffic": {"options": {"lde_blowup_factor": 2}},
           "gpu": {"sm_count": 132, "max_sm_clock_hz": 1980e6},
           "window": {"start": 0.0, "end": 6.5, "proofs": proofs},
           "profile": None}
    if profile:
        # one profiled prove from t = 1000 us: 4 ms busy inside the base
        # LDE (10 ms long), 2 ms inside the extension LDE, a copy
        start = 1000.0
        base = (start, start + 10000)
        ext = (start + 13000, start + 17000)
        device = [_ev(base[0], 3000), _ev(base[0] + 5000, 1000),
                  _ev(ext[0], 2000), _ev(ext[1] + 100, 500, "gpu_memcpy")]
        rec["profile"] = {
            "device": device, "proofs": 1, "start_us": 0.0,
            "wall_us": 100000.0, "phases": [phases],
            "spans": [{"name": "window", "ts": 0.0, "dur": 100000.0},
                      {"name": "prove", "ts": start, "dur": 50000.0}]}
    return rec


@pytest.mark.parametrize("name, want", [
    ("setup_s", 12.5), ("prove_s", 6.5 / 3),
    ("peak_mem_gib", 3.0), ("load_s", 0.02), ("trace_build_s", 0.2),
    ("lde_s", 0.015), ("commit_s", 0.006), ("constraint_eval_s", 0.003),
    ("oods_deep_s", 0.006), ("fri_s", 0.005), ("queries_s", 0.004),
    ("device_idle_pct", 100 * (1 - 6.5 / 100)), ("copy_ms", 0.5),
    ("kernel_ms", 6.0)])
def test_readers_on_a_record(name, want):
    assert cells.reader(BENCH, name)(_record()) == pytest.approx(want)


def test_lde_roofline_reader():
    n = 16384 * 16
    least = (yardstick.lde_least_s(n, 2, 7, 132, 1980e6)
             + yardstick.lde_least_s(n, 2, 3, 132, 1980e6))
    got = cells.reader(BENCH, "lde_roofline_pct")(_record())
    assert got == pytest.approx(100 * least / 6e-3)


@pytest.mark.parametrize("name", ["device_idle_pct", "copy_ms", "kernel_ms",
                                  "lde_roofline_pct"])
def test_device_readers_read_nothing_without_a_trace(name):
    assert cells.reader(BENCH, name)(_record(profile=False)) is None


def test_a_missing_phase_fails_the_reader():
    rec = _record()
    for p in rec["window"]["proofs"]:
        p["phases"] = [ph for ph in p["phases"] if ph[0] != "FRI layers"]
    with pytest.raises(KeyError):
        cells.reader(BENCH, "fri_s")(rec)
    rec = _record()
    rec["profile"]["phases"] = [[ph for ph in rec["profile"]["phases"][0]
                                 if not ph[0].startswith("extension col")]]
    with pytest.raises(KeyError):
        cells.reader(BENCH, "lde_roofline_pct")(rec)
