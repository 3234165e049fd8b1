"""100 x the least time of the base and extension LDE / the device-busy time
inside the prover's phases "base columns interpolated + extended" and
"extension columns interpolated + extended", over the traced run's
profiled proofs.  The phases are placed on the profiler's clock from each
prove span's start and LAST_PHASES; the least time is reckoned from the
cell's shapes alone (yardstick.lde_least_s: the radix-2 minimum of the
interpolation and the blowup cosets, Fp252 products at the card's peak
multiply-add rate, or the bytes at its bandwidth, whichever is longer)."""

from portbench import yardstick
from portbench.reference.verify import LAYOUTS

PHASES = {"base columns interpolated + extended": "NUM_BASE_COLUMNS",
          "extension columns interpolated + extended":
              "NUM_EXTENSION_COLUMNS"}


def read(record):
    prof, gpu = record["profile"], record["gpu"]
    if prof is None or not prof["device"] or gpu is None:
        return None
    config = record["config"]
    air = LAYOUTS[config["layout"]]
    n = config["n_steps"] * air.CYCLE_HEIGHT
    blowup = record["traffic"]["options"]["lde_blowup_factor"]
    least = sum(yardstick.lde_least_s(n, blowup, getattr(air, attr),
                                      gpu["sm_count"], gpu["max_sm_clock_hz"])
                for attr in PHASES.values())
    busy = yardstick.busy_intervals(prof["device"])
    proves = [s for s in prof["spans"] if s["name"] == "prove"]
    inside_ms = 0.0
    for span, phases in zip(proves, prof["phases"]):
        found = set()
        for label, a, b in yardstick.phase_intervals(span["ts"], phases):
            if label in PHASES:
                inside_ms += yardstick.busy_ms_within(busy, a, b)
                found.add(label)
        if found != set(PHASES):
            raise KeyError(f"the prove recorded no {set(PHASES) - found}")
    return 100 * least * len(proves) / (inside_ms / 1e3)
