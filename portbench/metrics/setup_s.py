"""Set-up: from the process's start to the window's, imports, kernel load
(and build), the pool's VM runs and bundles, and the warm-up proof."""


def read(record):
    return record["setup_s"]
