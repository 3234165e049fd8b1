"""Vectorized Cairo instruction-word decode (copy of
sandstorm_tpu/binary/word.py).

Semantics parity with the reference's Word/Flag/FlagGroup
(binary/src/lib.rs:561-772; bit layout per the Cairo paper
https://eprint.iacr.org/2021/1063.pdf figure 3 / section 9.4):

- 63-bit first word: three 16-bit biased offsets (off_dst @0, off_op0 @16,
  off_op1 @32) then 15 flags @48 (bit 15 must be zero).
- flag prefixes f~_i = instruction >> (48+i) masked to (15-i) bits; the AIR
  commits the prefixes and derives each flag as f~_i - 2*f~_{i+1}.
- res is repurposed as dst^{-1} for the JNZ "conditional" path.

The whole-trace decode is a single pass of numpy ops (the reference decodes
one Word per cycle inside a rayon loop, plain/trace.rs:126-186); the few
genuinely modular computations (res/op0*op1/tmp1 and the dst inverse) are
done with python big-ints pending the device-side decode path.
"""

import dataclasses

import numpy as np

from .. import telemetry

# flag bit indices (binary/src/lib.rs:733-772)
FLAGS = {
    "DstReg": 0, "Op0Reg": 1, "Op1Imm": 2, "Op1Fp": 3, "Op1Ap": 4,
    "ResAdd": 5, "ResMul": 6, "PcJumpAbs": 7, "PcJumpRel": 8, "PcJnz": 9,
    "ApAdd": 10, "ApAdd1": 11, "OpcodeCall": 12, "OpcodeRet": 13,
    "OpcodeAssertEq": 14, "Zero": 15,
}

HALF_OFFSET = 1 << 15


def _limbs_to_ints(arr):
    """[n, 4] uint64 -> list of python ints."""
    a = np.asarray(arr, dtype=np.uint64)
    out = a[:, 0].astype(object)
    for i in range(1, 4):
        out = out | (a[:, i].astype(object) << (64 * i))
    return [int(v) for v in out]


@dataclasses.dataclass
class DecodedTrace:
    """Per-cycle decode of the full register trace. All arrays are length n."""
    n: int
    instruction: np.ndarray       # [n, 4] u64 limbs of the word
    flags: np.ndarray             # [n] uint16 (bits 48..63)
    flag_prefixes: np.ndarray     # [n, 16] uint16: f~_0..f~_15
    off_dst: np.ndarray           # [n] uint16 (biased)
    off_op0: np.ndarray
    off_op1: np.ndarray
    dst_addr: np.ndarray          # [n] uint64
    op0_addr: np.ndarray
    op1_addr: np.ndarray
    dst: list                     # python ints (field elements)
    op0: list
    op1: list
    res: list
    tmp0: list
    tmp1: list
    op0_mul_op1: list


def decode_words(register_states, memory, prime: int) -> DecodedTrace:
    """The whole register trace decoded (a span "trace.decode")."""
    with telemetry.span("trace.decode", cycles=len(register_states.arr)):
        return _decode_words(register_states, memory, prime)


def _decode_words(register_states, memory, prime: int) -> DecodedTrace:
    regs = register_states.arr
    n = regs.shape[0]
    ap = regs[:, 0]
    fp = regs[:, 1]
    pc = regs[:, 2]

    word = memory.values[pc]          # [n, 4]
    w0 = word[:, 0]

    off_dst = (w0 & np.uint64(0xFFFF)).astype(np.uint64)
    off_op0 = ((w0 >> np.uint64(16)) & np.uint64(0xFFFF)).astype(np.uint64)
    off_op1 = ((w0 >> np.uint64(32)) & np.uint64(0xFFFF)).astype(np.uint64)
    flags = (w0 >> np.uint64(48)).astype(np.uint16)
    assert not (flags >> 15).any(), "bit 63 (Zero flag) must be 0"

    def flag(name):
        return ((flags >> FLAGS[name]) & 1).astype(np.uint64)

    # flag prefixes f~_i (binary/src/lib.rs:568-577): for i<15,
    # prefix_i = flags >> i (implicitly masked: flags < 2^15); f~_15 = 0
    prefixes = np.zeros((n, 16), dtype=np.uint16)
    for i in range(15):
        prefixes[:, i] = flags >> i
    # (mask (1 << (15-i)) - 1 is a no-op since flags < 2^15)

    half = np.uint64(HALF_OFFSET)
    dst_base = np.where(flag("DstReg") == 1, fp, ap)
    op0_base = np.where(flag("Op0Reg") == 1, fp, ap)
    dst_addr = dst_base + off_dst - half
    op0_addr = op0_base + off_op0 - half

    # op1 base: flag group Op1Src = Op1Imm + 2*Op1Fp + 4*Op1Ap
    # (binary/src/lib.rs:616-621, 659-668): 0 -> [op0], 1 -> pc, 2 -> fp,
    # 4 -> ap
    op1_src = flag("Op1Imm") + 2 * flag("Op1Fp") + 4 * flag("Op1Ap")
    op0_value_low = memory.values[op0_addr][:, 0]  # op0 as an address
    op1_base = np.select(
        [op1_src == 0, op1_src == 1, op1_src == 2, op1_src == 4],
        [op0_value_low, pc, fp, ap],
    )
    assert np.isin(op1_src, (0, 1, 2, 4)).all(), "invalid Op1Src flag group"
    op1_addr = op1_base + off_op1 - half

    dst = _limbs_to_ints(memory.values[dst_addr])
    op0 = _limbs_to_ints(memory.values[op0_addr])
    op1 = _limbs_to_ints(memory.values[op1_addr])

    res_logic = flag("ResAdd") + 2 * flag("ResMul")
    pc_update = flag("PcJumpAbs") + 2 * flag("PcJumpRel") + 4 * flag("PcJnz")
    opcode = (flag("OpcodeCall") + 2 * flag("OpcodeRet")
              + 4 * flag("OpcodeAssertEq"))
    ap_update = flag("ApAdd") + 2 * flag("ApAdd1")

    res = [0] * n
    tmp0 = [0] * n
    tmp1 = [0] * n
    op0_mul_op1 = [0] * n
    for i in range(n):
        o0, o1, d = op0[i], op1[i], dst[i]
        op0_mul_op1[i] = o0 * o1 % prime
        pu = pc_update[i]
        if pu == 4:
            # JNZ: res unused, repurposed as dst^{-1} (lib.rs:684-696)
            assert res_logic[i] == 0 and opcode[i] == 0 and ap_update[i] != 1
            res[i] = pow(d, prime - 2, prime) if d else 0
        elif pu in (0, 1, 2):
            rl = res_logic[i]
            if rl == 0:
                res[i] = o1
            elif rl == 1:
                res[i] = (o0 + o1) % prime
            elif rl == 2:
                res[i] = o0 * o1 % prime
            else:
                raise ValueError(f"invalid ResLogic at cycle {i}")
        else:
            raise ValueError(f"invalid PcUpdate at cycle {i}")
        if (flags[i] >> FLAGS["PcJnz"]) & 1:
            tmp0[i] = d
            tmp1[i] = d * res[i] % prime

    return DecodedTrace(
        n=n, instruction=word, flags=flags, flag_prefixes=prefixes,
        off_dst=off_dst.astype(np.uint16), off_op0=off_op0.astype(np.uint16),
        off_op1=off_op1.astype(np.uint16),
        dst_addr=dst_addr, op0_addr=op0_addr, op1_addr=op1_addr,
        dst=dst, op0=op0, op1=op1, res=res, tmp0=tmp0, tmp1=tmp1,
        op0_mul_op1=op0_mul_op1,
    )
