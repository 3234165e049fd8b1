"""100 x (1 - the union of the device's kernel, copy and set intervals / the
profiled wall) over the traced run's profiled proofs (torch.profiler)."""

from portbench import yardstick


def read(record):
    prof = record["profile"]
    if prof is None or not prof["device"]:
        return None
    return 100 * (1 - yardstick.busy_ms(prof["device"]) * 1e3
                  / prof["wall_us"])
