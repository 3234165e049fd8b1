"""Mean over the window's proofs of the seconds of the span "trace.build"
(the layout's trace builder, layouts/) less those of its children
"trace.decode" and "trace.builtin.<name>": the builder's own sections (the
CPU cells, the range-check pool, the limb packing, the diluted pool, the
ordered memory).

The proofs are the requests of the program's recorder
(sandstorm_tpu_torch.telemetry) whose "prove" span ended inside the
window (the same perf_counter clock); a window with none fails the run.  A
program without the recorder reads nothing."""

import importlib.util


def _columns_s(request):
    total = 0.0
    for build in request.find("trace.build"):
        total += build.seconds - sum(
            c.seconds for c in request.children(build)
            if c.name == "trace.decode"
            or c.name.startswith("trace.builtin."))
    return total


def read(record):
    if importlib.util.find_spec("sandstorm_tpu_torch.telemetry") is None:
        return None
    from sandstorm_tpu_torch import telemetry
    proofs = telemetry.proofs_between(record["window"]["start"],
                                      record["window"]["end"])
    return sum(_columns_s(r) for r in proofs) / len(proofs)
