"""The AIR public input JSON of a cairo-run bundle (layout, rc bounds,
n_steps, memory segments, public memory) and the compiled program JSON:
a frozen copy of their parsers in sandstorm_tpu_torch/binary/formats.py
(the reference sandstorm's binary/src/lib.rs:223-340, 537-559)."""

import dataclasses
import json
import os
from enum import Enum


class Layout(Enum):
    """SHARP layouts (binary/src/lib.rs:58-145)."""
    PLAIN = "plain"
    SMALL = "small"
    DEX = "dex"
    RECURSIVE = "recursive"
    STARKNET = "starknet"
    RECURSIVE_LARGE_OUTPUT = "recursive_large_output"
    ALL_SOLIDITY = "all_solidity"
    STARKNET_WITH_KECCAK = "starknet_with_keccak"

    def sharp_code(self) -> int:
        """The layout's name as a big-endian integer (its code in the
        verifiers' public input, aux_input.py)."""
        return int.from_bytes(self.value.encode(), "big")


def _parse_hex(v) -> int:
    return int(v, 16) if isinstance(v, str) else int(v)


def _load_json(obj_or_path):
    if isinstance(obj_or_path, (str, os.PathLike)):
        with open(obj_or_path) as f:
            return json.load(f)
    return obj_or_path


@dataclasses.dataclass(frozen=True)
class MemoryEntry:
    address: int
    value: int  # canonical field int


@dataclasses.dataclass(frozen=True)
class Segment:
    begin_addr: int
    stop_ptr: int


@dataclasses.dataclass
class AirPublicInput:
    layout: Layout
    rc_min: int
    rc_max: int
    n_steps: int
    memory_segments: dict  # name -> Segment
    public_memory: list    # list[MemoryEntry]

    @classmethod
    def from_json(cls, obj_or_path) -> "AirPublicInput":
        obj = _load_json(obj_or_path)
        return cls(
            layout=Layout(obj["layout"]),
            rc_min=int(obj["rc_min"]),
            rc_max=int(obj["rc_max"]),
            n_steps=int(obj["n_steps"]),
            memory_segments={
                name: Segment(int(seg["begin_addr"]), int(seg["stop_ptr"]))
                for name, seg in obj["memory_segments"].items()},
            public_memory=[
                MemoryEntry(int(e["address"]), _parse_hex(e["value"]))
                for e in obj["public_memory"]])

    # helpers mirroring binary/src/lib.rs:300-338
    def initial_pc(self) -> int:
        return self.memory_segments["program"].begin_addr

    def final_pc(self) -> int:
        return self.memory_segments["program"].stop_ptr

    def initial_ap(self) -> int:
        return self.memory_segments["execution"].begin_addr

    def final_ap(self) -> int:
        return self.memory_segments["execution"].stop_ptr

    def public_memory_padding(self) -> MemoryEntry:
        """The address-1 entry is reused as padding (binary/src/lib.rs:332)."""
        for e in self.public_memory:
            if e.address == 1:
                return e
        raise ValueError("no public memory entry at address 1")


def program_words(obj_or_path):
    """The words of a compiled program JSON ({"data": [hex], "prime": hex})
    and its prime."""
    obj = _load_json(obj_or_path)
    return [_parse_hex(v) for v in obj["data"]], _parse_hex(obj["prime"])
