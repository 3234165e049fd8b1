"""Mean over the window's proofs of the bytes the program counted as
"h2d_bytes" (telemetry.to_device, from the tensors' sizes), in MiB.

The proofs are the requests of the program's recorder
(sandstorm_tpu_torch.telemetry) whose "prove" span ended inside the
window (the same perf_counter clock); a window with none fails the run.  A
program without the recorder reads nothing."""

import importlib.util


def read(record):
    if importlib.util.find_spec("sandstorm_tpu_torch.telemetry") is None:
        return None
    from sandstorm_tpu_torch import telemetry
    proofs = telemetry.proofs_between(record["window"]["start"],
                                      record["window"]["end"])
    return sum(r.counts()["h2d_bytes"] for r in proofs) / len(proofs) \
        / 2 ** 20
