"""Transcript seeding shared by prover and verifier (copy of
sandstorm_tpu/stark/transcript.py): the coin is seeded from a canonical
serialization of the AIR public input, the proof options and the trace
length."""

import struct

from ..coin import PublicCoin


def serialize_public_input(pub) -> bytes:
    parts = [pub.layout.value.encode(),
             struct.pack(">QQQ", pub.rc_min, pub.rc_max, pub.n_steps)]
    for name in sorted(pub.memory_segments):
        seg = pub.memory_segments[name]
        parts.append(name.encode())
        parts.append(struct.pack(">QQ", seg.begin_addr, seg.stop_ptr))
    for e in pub.public_memory:
        parts.append(struct.pack(">Q", e.address))
        parts.append(int(e.value).to_bytes(32, "big"))
    return b"\x00".join(parts)


def make_coin(pub, options, trace_len: int) -> PublicCoin:
    seed = (serialize_public_input(pub) + options.to_bytes()
            + struct.pack(">Q", trace_len))
    return PublicCoin(seed)
