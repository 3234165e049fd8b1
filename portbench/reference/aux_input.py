"""Frozen copy of sandstorm_tpu_torch/aux_input.py: the byte-exact public-input
element stream of the Solidity and Cairo verifiers (the reference
sandstorm's src/input.rs:9-151), which seeds both coins."""

from .public_input import Layout


def _seg(segments, name):
    s = segments[name]
    return [s.begin_addr, s.stop_ptr]


class CairoAuxInput:
    def __init__(self, public_input):
        self.pub = public_input

    def base_values(self):
        pub = self.pub
        segments = pub.memory_segments
        assert pub.n_steps & (pub.n_steps - 1) == 0
        head = [pub.n_steps.bit_length() - 1, pub.rc_min, pub.rc_max,
                pub.layout.sharp_code()]
        if pub.layout == Layout.PLAIN:
            # the reference never pairs the plain layout with the SHARP
            # coins (input.rs supports starknet/recursive only; plain runs
            # the generic coin, cli/src/main.rs:103-133) — this extension
            # covers the builtin-free segment list so every scheme works
            # on every layout here
            return head + _seg(segments, "program") + _seg(
                segments, "execution")
        return (head
                + _seg(segments, "program") + _seg(segments, "execution")
                + _seg(segments, "output") + _seg(segments, "pedersen")
                + _seg(segments, "range_check"))

    def layout_specific_values(self):
        pub = self.pub
        segments = pub.memory_segments
        pad = pub.public_memory_padding()
        if pub.layout == Layout.STARKNET:
            return (_seg(segments, "ecdsa") + _seg(segments, "bitwise")
                    + _seg(segments, "ec_op") + _seg(segments, "poseidon")
                    + [pad.address, pad.value, 1])
        if pub.layout == Layout.RECURSIVE:
            return _seg(segments, "bitwise") + [pad.address, pad.value, 1]
        if pub.layout == Layout.PLAIN:
            return [pad.address, pad.value, 1]
        raise NotImplementedError(f"aux input for layout {pub.layout}")

    def memory_page_values(self, hash_fn):
        """Main-page info: [page size, page hash] (input.rs:113-141)."""
        elements = []
        for e in self.pub.public_memory:
            elements.append(e.address)
            elements.append(e.value)
        page_hash = hash_fn.hash_elements(elements)
        if isinstance(page_hash, bytes):
            page_hash = int.from_bytes(page_hash, "big")
        return [len(self.pub.public_memory), page_hash]

    def public_input_elements(self, hash_fn):
        return (self.base_values() + self.layout_specific_values()
                + self.memory_page_values(hash_fn))

    def serialize(self, hash_fn) -> bytes:
        return b"".join(int(v).to_bytes(32, "big")
                        for v in self.public_input_elements(hash_fn))
