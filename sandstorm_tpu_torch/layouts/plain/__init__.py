"""The `plain` SHARP layout: minimal CPU-only Cairo AIR.

Layout parameters per the reference sandstorm's layouts/src/plain/mod.rs:10-17.
"""

CYCLE_HEIGHT = 16
PUBLIC_MEMORY_STEP = 8
MEMORY_STEP = 2
RANGE_CHECK_STEP = 4
NUM_BASE_COLUMNS = 5
NUM_EXTENSION_COLUMNS = 1
