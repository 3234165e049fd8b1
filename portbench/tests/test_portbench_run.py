"""The harness's run, on the CPU through the test-only 16-step plain cell
(the look for a card skipped): correct with the program as it is, not
correct with each fault planted underneath (portbench/control.py): the
control (the grind skipped), a proof byte altered where it is produced,
a trace cell altered where the trace build produces it."""

import time

import pytest
import torch

from portbench import control, run
from portbench.tests.conftest import TINY_CELL

SEED = 2 ** 31 + 11


def _run(bench_copy, device, seconds=0.5, trace=0):
    return run.run_cell(bench_copy, TINY_CELL, SEED, seconds, trace, device,
                        t_process=time.perf_counter())


def test_the_tiny_cell_is_correct(bench_copy):
    result = _run(bench_copy, torch.device("cpu"))
    assert result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"prove_s", "setup_s"}
    assert list(result)[-1] == "checks"
    assert result["checks"] == {"failed": {"value": 0, "limit": 0},
                                "unchecked": {"value": 0, "limit": 0},
                                "rejected": {"value": 0, "limit": 0}}


@pytest.mark.parametrize("fault", sorted(control.FAULTS))
def test_a_planted_fault_is_not_correct(bench_copy, fault):
    with control.FAULTS[fault]():
        result = _run(bench_copy, torch.device("cpu"))
    assert result["correct"] is False
    assert result["checks"]["rejected"]["value"] >= 1


def test_faults_are_removed_on_leaving(bench_copy):
    from sandstorm_tpu_torch import claims
    from sandstorm_tpu_torch.crypto import coins
    from sandstorm_tpu_torch.stark import ark
    before = (ark.serialize_proof, claims.CairoClaim.generate_trace,
              coins._VerifierCoin.grind_proof_of_work)
    for fault in control.FAULTS.values():
        with fault():
            pass
    assert before == (ark.serialize_proof, claims.CairoClaim.generate_trace,
                      coins._VerifierCoin.grind_proof_of_work)


def test_without_a_card_the_run_exits_2_with_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "recursive-cairo-b2", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_the_tiny_cell_on_the_card(bench_copy, cuda_device):
    result = _run(bench_copy, cuda_device, trace=1)
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
    with control.FAULTS["skip_grind"]():
        assert _run(bench_copy, cuda_device)["correct"] is False
