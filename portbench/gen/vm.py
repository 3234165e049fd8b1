"""A minimal Cairo machine that runs a compiled program into a register
trace and memory: a frozen copy of sandstorm_tpu_torch/runner/vm.py (the
Cairo whitepaper's state transition, sections 4.5 and 9.4), whose
to_witness_arrays and build_public_input return plain arrays and dicts
for the bundle writer instead of the program's types.
"""

import numpy as np

FLAGS = {
    "DstReg": 0, "Op0Reg": 1, "Op1Imm": 2, "Op1Fp": 3, "Op1Ap": 4,
    "ResAdd": 5, "ResMul": 6, "PcJumpAbs": 7, "PcJumpRel": 8, "PcJnz": 9,
    "ApAdd": 10, "ApAdd1": 11, "OpcodeCall": 12, "OpcodeRet": 13,
    "OpcodeAssertEq": 14, "Zero": 15,
}

HALF = 1 << 15


def assemble_instruction(off_dst=0, off_op0=-1, off_op1=1, flags=()):
    """Build a 63-bit Cairo word from offsets (unbiased) + flag names."""
    word = (off_dst + HALF) | ((off_op0 + HALF) << 16) | ((off_op1 + HALF) << 32)
    for f in flags:
        word |= 1 << (48 + FLAGS[f])
    return word


# canonical encodings (match cairo-compile output for these statements)
def instr_assert_eq_imm():
    """[ap] = imm; ap++  (0x480680017fff8000)"""
    return assemble_instruction(0, -1, 1, ("Op0Reg", "Op1Imm", "ApAdd1",
                                           "OpcodeAssertEq"))


def instr_jmp_rel_imm():
    """jmp rel imm  (0x010780017fff7fff with imm 0 = the padding loop)"""
    return assemble_instruction(-1, -1, 1, ("DstReg", "Op0Reg", "Op1Imm",
                                            "PcJumpRel"))


class CairoVM:
    def __init__(self, program_words, prime: int):
        self.p = prime
        self.memory = {}  # addr -> int
        for i, w in enumerate(program_words):
            self.memory[i + 1] = w
        self.program_len = len(program_words)

    def _flag(self, word, name):
        return (word >> (48 + FLAGS[name])) & 1

    def run(self, num_cycles: int, initial_ap: int, extra_memory=None):
        """Execute num_cycles steps from pc=1, ap=fp=initial_ap."""
        mem = self.memory
        if extra_memory:
            mem.update(extra_memory)
        ap, fp, pc = initial_ap, initial_ap, 1
        trace = np.zeros((num_cycles, 3), dtype=np.uint64)
        p = self.p
        for step in range(num_cycles):
            trace[step] = (ap, fp, pc)
            word = mem[pc]
            off_dst = (word & 0xFFFF) - HALF
            off_op0 = ((word >> 16) & 0xFFFF) - HALF
            off_op1 = ((word >> 32) & 0xFFFF) - HALF
            fl = lambda name: self._flag(word, name)

            dst_addr = (fp if fl("DstReg") else ap) + off_dst
            op0_addr = (fp if fl("Op0Reg") else ap) + off_op0
            op1_src = fl("Op1Imm") + 2 * fl("Op1Fp") + 4 * fl("Op1Ap")
            size = 2 if fl("Op1Imm") else 1
            opcode = (fl("OpcodeCall") + 2 * fl("OpcodeRet")
                      + 4 * fl("OpcodeAssertEq"))

            # nondeterministic pushes for CALL (whitepaper 4.5 / section 8.4)
            if opcode == 1:
                mem[dst_addr] = fp            # dst asserts [ap] == fp
                mem[op0_addr] = pc + size     # op0 asserts [ap+1] == ret pc

            op0 = mem[op0_addr] if op0_addr in mem else None
            if op1_src == 0:
                assert op0 is not None, f"op0 unknown at step {step}"
                op1_addr = op0 + off_op1
            elif op1_src == 1:
                op1_addr = pc + off_op1
            elif op1_src == 2:
                op1_addr = fp + off_op1
            elif op1_src == 4:
                op1_addr = ap + off_op1
            else:
                raise ValueError("invalid op1 source")
            op1 = mem.get(op1_addr)

            res_logic = fl("ResAdd") + 2 * fl("ResMul")
            pc_update = fl("PcJumpAbs") + 2 * fl("PcJumpRel") + 4 * fl("PcJnz")
            if pc_update == 4:
                res = None  # unused/jnz
            elif res_logic == 0:
                res = op1
            elif res_logic == 1:
                res = (op0 + op1) % p
            elif res_logic == 2:
                res = op0 * op1 % p
            else:
                raise ValueError("invalid res logic")

            if opcode == 4:  # ASSERT_EQ: dst := res if unknown
                if dst_addr not in mem:
                    mem[dst_addr] = res
            dst = mem.get(dst_addr)

            if pc_update == 0:
                pc = pc + size
            elif pc_update == 1:
                pc = res
            elif pc_update == 2:
                pc = (pc + res) % p
            elif pc_update == 4:  # jnz
                pc = (pc + op1) % p if dst != 0 else pc + size
            else:
                raise ValueError("invalid pc update")

            ap_update = fl("ApAdd") + 2 * fl("ApAdd1")
            if opcode == 1:
                assert ap_update == 0
                ap = ap + 2
            elif ap_update == 1:
                ap = (ap + res) % p
            elif ap_update == 2:
                ap = ap + 1

            if opcode == 1:      # call
                fp = ap
            elif opcode == 2:    # ret
                fp = dst

        return trace, mem

    def to_witness_arrays(self, trace, mem):
        """The register trace [n, 3] and the memory as (addresses, values):
        every known cell, values as [k, 4] little-endian u64 words."""
        addrs = np.array(sorted(mem), dtype=np.uint64)
        values = np.zeros((len(addrs), 4), dtype=np.uint64)
        for k, a in enumerate(addrs):
            v = int(mem[int(a)])
            for i in range(4):
                values[k, i] = (v >> (64 * i)) & 0xFFFFFFFFFFFFFFFF
        return np.asarray(trace, dtype=np.uint64), (addrs, values)

    def build_public_input(self, trace, mem, layout: str = "plain"):
        """The AIR public input of a finished run as its JSON object (the
        program words are its public memory)."""
        registers = trace
        n = registers.shape[0]
        off_cols = []
        for step in range(n):
            word = mem[int(registers[step, 2])]
            off_cols += [word & 0xFFFF, (word >> 16) & 0xFFFF,
                         (word >> 32) & 0xFFFF]
        return {
            "layout": layout,
            "rc_min": int(min(off_cols)), "rc_max": int(max(off_cols)),
            "n_steps": n,
            "memory_segments": {
                "program": {"begin_addr": 1,
                            "stop_ptr": int(registers[-1, 2])},
                "execution": {"begin_addr": int(registers[0, 0]),
                              "stop_ptr": int(registers[-1, 0])},
            },
            "public_memory": [
                {"address": i + 1, "value": hex(mem[i + 1]), "page": 0}
                for i in range(self.program_len)],
        }
