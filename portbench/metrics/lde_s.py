"""Mean over the window's proofs of the seconds of the prover's phases "base
columns interpolated + extended", "extension columns interpolated +
extended" and "composition interpolated + split + extended" (stark/prover.py
LAST_PHASES, each phase ending in a device synchronize); a phase the prove
did not record fails the run."""

from portbench import yardstick

LABELS = ("base columns interpolated + extended",
          "extension columns interpolated + extended",
          "composition interpolated + split + extended")


def read(record):
    return yardstick.phase_mean(record, LABELS)
