"""The 128-bit range-check builtin: a value as 8 big-endian 16-bit parts
(copy of sandstorm_tpu/builtins/range_check.py; the reference sandstorm's
builtins/src/range_check/mod.rs: value = sum part_i * 2^(16 (N - 1 - i)))."""

import dataclasses

NUM_PARTS = 8


@dataclasses.dataclass
class InstanceTrace:
    index: int
    value: int
    parts: list  # NUM_PARTS 16-bit values, big-endian

    @classmethod
    def new(cls, index: int, value: int, num_parts: int = NUM_PARTS):
        assert 0 <= value < (1 << (16 * num_parts))
        parts = [(value >> (16 * (num_parts - 1 - i))) & 0xFFFF
                 for i in range(num_parts)]
        return cls(index=index, value=value, parts=parts)
