"""Bitwise builtin: &, ^, | on 256-bit values with "diluted" bit partitions
(copy of sandstorm_tpu/builtins/bitwise.py).

Parity with the reference sandstorm's builtins/src/bitwise/mod.rs: values are
decomposed into 4-spaced ("diluted") partitions so a single algebraic
identity checks all three ops:  x & y = (x_dil * y_dil) undiluted, etc.

dilute(x, spacing): spreads the bits of x so bit i lands at position
i*spacing (bitwise/mod.rs:127-133).
"""

import dataclasses

SPACING = 4


def dilute(x: int, spacing: int = SPACING) -> int:
    out = 0
    i = 0
    while x:
        out |= (x & 1) << (i * spacing)
        x >>= 1
        i += 1
    return out


def undilute(x: int, spacing: int = SPACING) -> int:
    out = 0
    i = 0
    while x:
        out |= (x & 1) << i
        x >>= spacing
        i += 1
    return out


def partition(x: int, n_bits: int = 256, chunk_bits: int = 64,
              spacing: int = SPACING):
    """Split x into diluted chunk words: chunk j covers bits
    [j*chunk_bits/spacing, ...) of the SPACING-strided bit classes.

    For the recursive/starknet layouts: a 256-bit value yields, per
    spacing-offset s in 0..4 and 64-bit window w, the diluted word of bits
    {s + 4k : k} restricted to the window — 4*4 = 16 segments of 16 bits
    each (cf. recursive/trace.rs bitwise dilution, 16 segs/instance).
    """
    segments = []
    for offset in range(spacing):
        # the bit class {offset + spacing*k}
        bits = 0
        k = 0
        y = x >> offset
        while y:
            bits |= (y & 1) << k
            y >>= spacing
            k += 1
        # bits is a 64-bit value for a 256-bit input; split into 16-bit
        # quarters, diluted back to 64 bits each
        for q in range(n_bits // spacing // 16):
            quarter = (bits >> (16 * q)) & 0xFFFF
            segments.append(dilute(quarter, spacing))
    return segments


@dataclasses.dataclass
class InstanceTrace:
    index: int
    x: int
    y: int
    x_and_y: int
    x_xor_y: int
    x_or_y: int
    x_dilution: list   # 16 diluted 16-bit segments
    y_dilution: list
    x_and_y_dilution: list
    x_xor_y_dilution: list

    @classmethod
    def new(cls, index: int, x: int, y: int):
        x_and_y = x & y
        x_xor_y = x ^ y
        return cls(
            index=index, x=x, y=y,
            x_and_y=x_and_y, x_xor_y=x_xor_y, x_or_y=x | y,
            x_dilution=partition(x),
            y_dilution=partition(y),
            x_and_y_dilution=partition(x_and_y),
            x_xor_y_dilution=partition(x_xor_y),
        )
