"""Mean over the window's proofs of the seconds of the prover's phases "FRI
layers" and "FRI remainder" (stark/prover.py LAST_PHASES, each phase ending
in a device synchronize); a phase the prove did not record fails the run."""

from portbench import yardstick

LABELS = ("FRI layers", "FRI remainder")


def read(record):
    return yardstick.phase_mean(record, LABELS)
