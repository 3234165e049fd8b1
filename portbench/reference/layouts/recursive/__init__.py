"""The `recursive` SHARP layout: CPU + pedersen + 128-bit range-check +
bitwise builtins with diluted checks, over the 252-bit Starkware field
(port of sandstorm_tpu/layouts/recursive/).

Parameter parity with the reference sandstorm's layouts/src/recursive/mod.rs
and the column map in recursive/air.rs:1324-1729 (7 base + 3 extension
columns).
"""

CYCLE_HEIGHT = 16
PUBLIC_MEMORY_STEP = 16
MEMORY_STEP = 2
RANGE_CHECK_STEP = 4
DILUTED_CHECK_STEP = 1

PEDERSEN_BUILTIN_RATIO = 128        # cycles per pedersen hash
RANGE_CHECK_BUILTIN_RATIO = 8       # cycles per 128-bit range check
RANGE_CHECK_BUILTIN_PARTS = 8
BITWISE_RATIO = 8                   # cycles per bitwise instance

DILUTED_CHECK_N_BITS = 16
DILUTED_CHECK_SPACING = 4

NUM_BASE_COLUMNS = 7
NUM_EXTENSION_COLUMNS = 3

from .air import RecursiveAirConfig      # noqa: E402,F401
