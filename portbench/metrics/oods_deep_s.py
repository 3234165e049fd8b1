"""Mean over the window's proofs of the seconds of the prover's phases "OODS
openings" and "DEEP composition" (stark/prover.py LAST_PHASES, each phase
ending in a device synchronize); a phase the prove did not record fails the
run."""

from portbench import yardstick

LABELS = ("OODS openings", "DEEP composition")


def read(record):
    return yardstick.phase_mean(record, LABELS)
