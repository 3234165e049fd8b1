"""Cairo run artifacts in memory: the register trace, the memory, the AIR
public and private inputs and the witness bundle (copy of the parts of
sandstorm_tpu/binary/formats.py that the plain-layout slice reads; the
artifact file parsers come with the CLI).

Format parity with the reference's `binary` crate: registers are
{ap, fp, pc} u64 triples (binary/src/lib.rs:52-57), memory values are
field-size little-endian words (binary/src/lib.rs:172-213), the public input
carries layout/rc_min/rc_max/n_steps/memory_segments/public_memory
(binary/src/lib.rs:223-340).
"""

import dataclasses
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


@dataclasses.dataclass
class CairoWitness:
    """The prover's private input bundle (layouts/src/lib.rs:37-56)."""
    air_private_input: AirPrivateInput
    register_states: RegisterStates
    memory: Memory
