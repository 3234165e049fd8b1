"""Mean over the window's proofs of the seconds of the prover's phases "base
commit", "extension commit" and "composition commit" (stark/prover.py
LAST_PHASES, each phase ending in a device synchronize); a phase the prove
did not record fails the run."""

from portbench import yardstick

LABELS = ("base commit", "extension commit", "composition commit")


def read(record):
    return yardstick.phase_mean(record, LABELS)
