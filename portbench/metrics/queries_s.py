"""Mean over the window's proofs of the seconds of the prover's phases "PoW +
queries" and "query assembly" (stark/prover.py LAST_PHASES, each phase
ending in a device synchronize); a phase the prove did not record fails the
run."""

from portbench import yardstick

LABELS = ("PoW + queries", "query assembly")


def read(record):
    return yardstick.phase_mean(record, LABELS)
