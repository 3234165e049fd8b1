"""Device ms of gpu_memcpy and gpu_memset a proof, over the traced run's
profiled proofs."""

from portbench import yardstick


def read(record):
    prof = record["profile"]
    if prof is None or not prof["device"]:
        return None
    by = yardstick.device_ms_by_kernel(prof["device"])
    return sum(by.get(c, (0.0, 0))[0] for c in ("gpu_memcpy", "gpu_memset")) \
        / prof["proofs"]
