"""Mean over the window's proofs of the seconds of the prover's phase
"constraint evaluation" (stark/prover.py LAST_PHASES, each phase ending in a
device synchronize); a phase the prove did not record fails the run."""

from portbench import yardstick

LABELS = ("constraint evaluation",)


def read(record):
    return yardstick.phase_mean(record, LABELS)
