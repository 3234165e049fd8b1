"""The `starknet` SHARP layout: CPU + pedersen + 128-bit range-check +
ECDSA + bitwise + EC-op + poseidon builtins with diluted checks, over the
252-bit Starkware field (port of sandstorm_tpu/layouts/starknet/).

Parameter parity with the reference sandstorm's layouts/src/starknet/mod.rs
and the column map in starknet/air.rs:2479-3241 (9 base + 1 extension
column).
"""

CYCLE_HEIGHT = 16
PUBLIC_MEMORY_STEP = 8
MEMORY_STEP = 2
RANGE_CHECK_STEP = 4
DILUTED_CHECK_STEP = 8

PEDERSEN_BUILTIN_RATIO = 32
RANGE_CHECK_BUILTIN_RATIO = 16
RANGE_CHECK_BUILTIN_PARTS = 8
BITWISE_RATIO = 64
ECDSA_BUILTIN_RATIO = 2048
EC_OP_BUILTIN_RATIO = 1024
EC_OP_SCALAR_HEIGHT = 256
EC_OP_N_BITS = 252
POSEIDON_RATIO = 32
POSEIDON_M = 3
POSEIDON_ROUNDS_FULL = 8
POSEIDON_ROUNDS_PARTIAL = 83

DILUTED_CHECK_N_BITS = 16
DILUTED_CHECK_SPACING = 4

NUM_BASE_COLUMNS = 9
NUM_EXTENSION_COLUMNS = 1

from .air import StarknetAirConfig          # noqa: E402,F401
