"""Parsers of cairo-run artifacts and their in-memory types: the register
trace, the memory, the AIR public and private inputs, the compiled program
and the witness bundle (copy of sandstorm_tpu/binary/formats.py).

Format parity with the reference's `binary` crate:
- trace.bin: a stream of {ap, fp, pc} little-endian u64 triples
  (binary/src/lib.rs:52-57, 152-162);
- memory.bin: a stream of (u64 address, field-size LE value) pairs, the
  value 32 bytes for the Starkware prime and 8 for Goldilocks
  (binary/src/lib.rs:172-213);
- compiled program JSON: {"data": [hex felts], "prime": hex}; program word
  i lives at address i + 1 (binary/src/lib.rs:537-559);
- AIR public input JSON: layout/rc_min/rc_max/n_steps/memory_segments/
  public_memory (binary/src/lib.rs:223-340);
- AIR private input JSON: trace and memory paths and the builtin instance
  lists (binary/src/lib.rs:342-535).
"""

import dataclasses
import json
import os
from enum import Enum

import numpy as np


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


@dataclasses.dataclass
class RegisterStates:
    """[n, 3] uint64 array with columns (ap, fp, pc)."""
    arr: np.ndarray

    @classmethod
    def from_bytes(cls, data: bytes) -> "RegisterStates":
        if len(data) % 24:
            raise ValueError("trace.bin must be a stream of 3 u64s")
        return cls(arr=np.frombuffer(data, dtype="<u8").reshape(-1, 3).copy())

    @classmethod
    def from_file(cls, path: str) -> "RegisterStates":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read())

    def __len__(self):
        return self.arr.shape[0]

    @property
    def ap(self):
        return self.arr[:, 0]

    @property
    def fp(self):
        return self.arr[:, 1]

    @property
    def pc(self):
        return self.arr[:, 2]


@dataclasses.dataclass
class Memory:
    """Sparse Cairo memory: dense value table + presence mask.

    values: [max_addr+1, 4] uint64 little-endian 64-bit words (u256 felts)
    known:  [max_addr+1] bool
    """
    values: np.ndarray
    known: np.ndarray

    @classmethod
    def from_bytes(cls, data: bytes, field_bytes: int = 32) -> "Memory":
        entry = 8 + field_bytes
        if len(data) % entry:
            raise ValueError(f"memory.bin must be a stream of {entry}-byte "
                             f"entries")
        n = len(data) // entry
        raw = np.frombuffer(data, dtype=np.uint8).reshape(n, entry)
        addrs = raw[:, :8].copy().view("<u8").reshape(n)
        vals = raw[:, 8:].copy().view("<u8").reshape(n, field_bytes // 8)
        max_addr = int(addrs.max()) if n else 0
        values = np.zeros((max_addr + 1, 4), dtype=np.uint64)
        known = np.zeros(max_addr + 1, dtype=bool)
        values[addrs, :field_bytes // 8] = vals
        known[addrs] = True
        return cls(values=values, known=known)

    @classmethod
    def from_file(cls, path: str, field_bytes: int = 32) -> "Memory":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read(), field_bytes)

    def __len__(self):
        return self.values.shape[0]

    def value_int(self, addr: int) -> int:
        w = self.values[addr]
        return (int(w[0]) | int(w[1]) << 64 | int(w[2]) << 128
                | int(w[3]) << 192)

    def set(self, addr: int, value: int):
        """Write one cell, growing the table if addr is past its end."""
        if addr >= len(self):
            grow = addr + 1 - len(self)
            self.values = np.vstack(
                [self.values, np.zeros((grow, 4), dtype=np.uint64)])
            self.known = np.concatenate(
                [self.known, np.zeros(grow, dtype=bool)])
        for i in range(4):
            self.values[addr, i] = (value >> (64 * i)) & 0xFFFFFFFFFFFFFFFF
        self.known[addr] = True


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
    # the recorder's request of the load that read it (telemetry), handed
    # on to the first claim made of it
    request: int = dataclasses.field(default=None, compare=False,
                                     repr=False)

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


@dataclasses.dataclass
class AirPrivateInput:
    trace_path: str
    memory_path: str
    pedersen: list
    range_check: list
    ecdsa: list
    bitwise: list
    ec_op: list
    poseidon: list

    @classmethod
    def from_json(cls, obj_or_path) -> "AirPrivateInput":
        """The trace and memory paths stay as written: examples.py resolves
        them against the bundle's directory."""
        obj = _load_json(obj_or_path)
        return cls(
            trace_path=obj.get("trace_path", ""),
            memory_path=obj.get("memory_path", ""),
            **{name: obj.get(name, []) or [] for name in (
                "pedersen", "range_check", "ecdsa", "bitwise", "ec_op",
                "poseidon")})


@dataclasses.dataclass
class CompiledProgram:
    data: list   # list[int] program words
    prime: int

    @classmethod
    def from_json(cls, obj_or_path) -> "CompiledProgram":
        obj = _load_json(obj_or_path)
        return cls(data=[_parse_hex(v) for v in obj["data"]],
                   prime=_parse_hex(obj["prime"]))

    def program_memory(self):
        """Word i -> address i + 1 (address 0 is reserved; lib.rs:547-556)."""
        return [MemoryEntry(i + 1, v) for i, v in enumerate(self.data)]


@dataclasses.dataclass
class CairoWitness:
    """The prover's private input bundle (layouts/src/lib.rs:37-56)."""
    air_private_input: AirPrivateInput
    register_states: RegisterStates
    memory: Memory
