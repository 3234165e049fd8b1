"""Device ms of kernels a proof, over the traced run's profiled proofs."""


def read(record):
    prof = record["profile"]
    if prof is None or not prof["device"]:
        return None
    return sum(e["dur"] for e in prof["device"]
               if e["cat"] == "kernel") / 1e3 / prof["proofs"]
