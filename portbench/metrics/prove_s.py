"""The window's time a proof: (end of the last proof - start of the first)
/ proofs completed, the window stretched to whole proofs."""

from portbench import yardstick


def read(record):
    w = record["window"]
    return yardstick.mean_seconds(w["start"], w["end"], len(w["proofs"]))
