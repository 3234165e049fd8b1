"""AIR for the `plain` Cairo layout: 47 constraints over 5 base + 1
extension column (a copy of sandstorm_tpu/layouts/plain/air.py over the
port's expression DSL).

Constraint-set parity with the reference sandstorm's
layouts/src/plain/air.rs:36-533 (itself derived from the Cairo paper, https://eprint.iacr.org/2021/1063.pdf
sections 9.4-9.10, and StarkWare's StarkEx constraint naming).  The virtual
column map (cell positions & strides) matches plain/air.rs:571-838 so traces
are interchangeable at the layout level:

  col0 Flags (16 bit-prefixes/cycle), col1 Npc (pc/instruction/memory
  accesses, pub-mem pairs at step 8), col2 Mem (address,value at step 2),
  col3 RangeCheck (offsets + sorted values at step 4), col4 Auxiliary
  (tmp0/tmp1), col5 (extension) Permutation (memory at step 2 shift 0,
  range-check at step 4 shift 1).

Expressions are built in the symbolic DSL (air/expr.py) and evaluated
batched over the constraint-evaluation domain on device.
"""

from ...air.expr import X, Constant, Trace, Challenge, Hint
from . import CYCLE_HEIGHT, PUBLIC_MEMORY_STEP, MEMORY_STEP, RANGE_CHECK_STEP

# -- challenges (plain/air.rs:810-838) ---------------------------------------
MEMORY_Z = 0       # MemoryPermutation::Z
MEMORY_A = 1       # MemoryPermutation::A
RC_Z = 2           # RangeCheckPermutation::Z
NUM_CHALLENGES = 3

# -- hints (plain/air.rs:535-568 PublicInputHint) ----------------------------
H_INITIAL_AP = 0
H_INITIAL_PC = 1
H_FINAL_AP = 2
H_FINAL_PC = 3
H_MEMORY_PRODUCT = 4
H_RC_PRODUCT = 5
H_RC_MIN = 6
H_RC_MAX = 7
NUM_HINTS = 8

# flag bit indices within the cycle (shared with binary.word.FLAGS)
F_DST_REG, F_OP0_REG, F_OP1_IMM, F_OP1_FP, F_OP1_AP = 0, 1, 2, 3, 4
F_RES_ADD, F_RES_MUL = 5, 6
F_PC_JUMP_ABS, F_PC_JUMP_REL, F_PC_JNZ = 7, 8, 9
F_AP_ADD, F_AP_ADD1 = 10, 11
F_OPCODE_CALL, F_OPCODE_RET, F_OPCODE_ASSERT_EQ = 12, 13, 14
F_ZERO = 15

# Npc column cells (plain/air.rs:649-675)
NPC_PC, NPC_INSTRUCTION = 0, 1
NPC_PUBMEM_ADDR, NPC_PUBMEM_VAL = 2, 3
NPC_MEM_OP0_ADDR, NPC_MEM_OP0 = 4, 5
NPC_GAP_ADDR, NPC_GAP_VAL = 6, 7
NPC_MEM_DST_ADDR, NPC_MEM_DST = 8, 9
NPC_MEM_OP1_ADDR, NPC_MEM_OP1 = 12, 13

# RangeCheck column cells (plain/air.rs:719-741)
RC_OFF_DST, RC_ORDERED, RC_AP = 0, 2, 3
RC_OFF_OP1, RC_OP0_MUL_OP1, RC_OFF_OP0 = 4, 7, 8
RC_FP, RC_UNUSED, RC_RES = 11, 12, 15

AUX_TMP0, AUX_TMP1 = 0, 8


def flag(bit, cycle_offset=0):
    """Flag bit = prefix_i - 2*prefix_{i+1} (plain/air.rs:631-645)."""
    off = CYCLE_HEIGHT * cycle_offset + bit
    return Trace(0, off) - 2 * Trace(0, off + 1)


def npc(cell, offset=0):
    step = PUBLIC_MEMORY_STEP if cell in (NPC_PUBMEM_ADDR, NPC_PUBMEM_VAL) \
        else CYCLE_HEIGHT
    return Trace(1, step * offset + cell)


def mem(cell, offset=0):
    return Trace(2, MEMORY_STEP * offset + cell)  # 0=Address, 1=Value


def rc(cell, offset=0):
    step = RANGE_CHECK_STEP if cell == RC_ORDERED else CYCLE_HEIGHT
    return Trace(3, step * offset + cell)


def aux(cell, offset=0):
    return Trace(4, CYCLE_HEIGHT * offset + cell)


def perm_mem(offset=0):
    return Trace(5, MEMORY_STEP * offset + 0)


def perm_rc(offset=0):
    return Trace(5, RANGE_CHECK_STEP * offset + 1)


class PlainAirConfig:
    """Plain-layout AirConfig (plain/air.rs:27-533)."""

    NUM_BASE_COLUMNS = 5
    NUM_EXTENSION_COLUMNS = 1
    NUM_CHALLENGES = NUM_CHALLENGES
    NUM_HINTS = NUM_HINTS
    CE_BLOWUP_FACTOR = 2
    CYCLE_HEIGHT = CYCLE_HEIGHT

    @staticmethod
    def constraints(trace_len: int, field_modulus: int, trace_gen: int,
                    base_modulus: int = None):
        """The 47 plain-layout constraints as DSL expressions.

        trace_gen is the order-trace_len root of unity (as a python int);
        zerofier constants are derived from it.
        """
        n = trace_len
        g = trace_gen
        p = field_modulus
        # domain constants (powers of the base-field trace generator) are
        # reduced mod the BASE modulus: for extension fields the packed
        # encoding is not the integer ring mod the field order
        pb = base_modulus or p
        assert n % CYCLE_HEIGHT == 0

        one = Constant(1)
        two = Constant(2)
        four = Constant(4)
        offset_size = Constant(1 << 16)
        half_offset_size = Constant(1 << 15)

        z_mem = Challenge(MEMORY_Z)
        a_mem = Challenge(MEMORY_A)
        z_rc = Challenge(RC_Z)

        # composite flag groups
        flag_op1_base_op0_0 = \
            one - (flag(F_OP1_IMM) + flag(F_OP1_AP) + flag(F_OP1_FP))
        flag_res_op1_0 = \
            one - (flag(F_RES_ADD) + flag(F_RES_MUL) + flag(F_PC_JNZ))
        flag_pc_update_regular_0 = \
            one - (flag(F_PC_JUMP_ABS) + flag(F_PC_JUMP_REL) + flag(F_PC_JNZ))
        fp_update_regular_0 = \
            one - (flag(F_OPCODE_CALL) + flag(F_OPCODE_RET))

        npc_reg_0 = npc(NPC_PC) + flag(F_OP1_IMM) + one

        memory_address_diff_0 = mem(0, 1) - mem(0, 0)
        rc16_diff_0 = rc(RC_ORDERED, 1) - rc(RC_ORDERED, 0)

        # zerofiers (worked examples in plain/air.rs:74-83,221-228,364-374)
        flag0_offset = Constant(pow(g, F_ZERO * n // CYCLE_HEIGHT, pb))
        flag0_zerofier = X.pow(n // CYCLE_HEIGHT) - flag0_offset
        flags_zerofier_inv = flag0_zerofier / (X.pow(n) - one)
        all_cycles_zerofier_inv = one / (X.pow(n // CYCLE_HEIGHT) - one)
        last_cycle_zerofier = X - Constant(
            pow(g, CYCLE_HEIGHT * (n // CYCLE_HEIGHT - 1), pb))
        all_cycles_except_last_zerofier_inv = \
            last_cycle_zerofier * all_cycles_zerofier_inv
        first_row_zerofier_inv = one / (X - one)
        every_second_row_zerofier_inv = one / (X.pow(n // 2) - one)
        second_last_row_zerofier = X - Constant(pow(g, 2 * (n // 2 - 1), pb))
        second_last_row_zerofier_inv = one / second_last_row_zerofier
        every_second_row_except_last_zerofier_inv = \
            second_last_row_zerofier * every_second_row_zerofier_inv
        every_eighth_row_zerofier_inv = one / (X.pow(n // 8) - one)
        every_fourth_row_zerofier_inv = one / (X.pow(n // 4) - one)
        fourth_last_row_zerofier = X - Constant(pow(g, 4 * (n // 4 - 1), pb))
        fourth_last_row_zerofier_inv = one / fourth_last_row_zerofier
        every_fourth_row_except_last_zerofier = \
            fourth_last_row_zerofier * every_fourth_row_zerofier_inv

        c = []

        # cpu/decode: flags are bits; prefix 15 is zero; offsets recompose
        c.append((flag(F_DST_REG) * flag(F_DST_REG) - flag(F_DST_REG))
                 * flags_zerofier_inv)
        # the zerofier's roots are rows ≡ 15 (mod 16), so the raw column
        # value there IS prefix 15 — forces f~_15 = 0 each cycle
        c.append(Trace(0, 0) / flag0_zerofier)
        c.append((npc(NPC_INSTRUCTION)
                  - (((Trace(0, 0) * offset_size + rc(RC_OFF_OP1)) * offset_size
                      + rc(RC_OFF_OP0)) * offset_size + rc(RC_OFF_DST)))
                 * all_cycles_zerofier_inv)
        for grp in (flag_op1_base_op0_0, flag_res_op1_0,
                    flag_pc_update_regular_0, fp_update_regular_0):
            c.append((grp * grp - grp) * all_cycles_zerofier_inv)

        # cpu/operands: address formation and res logic
        c.append((npc(NPC_MEM_DST_ADDR) + half_offset_size
                  - (flag(F_DST_REG) * rc(RC_FP)
                     + (one - flag(F_DST_REG)) * rc(RC_AP)
                     + rc(RC_OFF_DST))) * all_cycles_zerofier_inv)
        c.append((npc(NPC_MEM_OP0_ADDR) + half_offset_size
                  - (flag(F_OP0_REG) * rc(RC_FP)
                     + (one - flag(F_OP0_REG)) * rc(RC_AP)
                     + rc(RC_OFF_OP0))) * all_cycles_zerofier_inv)
        c.append((npc(NPC_MEM_OP1_ADDR) + half_offset_size
                  - (flag(F_OP1_IMM) * npc(NPC_PC)
                     + flag(F_OP1_AP) * rc(RC_AP)
                     + flag(F_OP1_FP) * rc(RC_FP)
                     + flag_op1_base_op0_0 * npc(NPC_MEM_OP0)
                     + rc(RC_OFF_OP1))) * all_cycles_zerofier_inv)
        c.append((rc(RC_OP0_MUL_OP1) - npc(NPC_MEM_OP0) * npc(NPC_MEM_OP1))
                 * all_cycles_zerofier_inv)
        c.append(((one - flag(F_PC_JNZ)) * rc(RC_RES)
                  - (flag(F_RES_ADD) * (npc(NPC_MEM_OP0) + npc(NPC_MEM_OP1))
                     + flag(F_RES_MUL) * rc(RC_OP0_MUL_OP1)
                     + flag_res_op1_0 * npc(NPC_MEM_OP1)))
                 * all_cycles_zerofier_inv)

        # cpu/update_registers: pc (incl. JNZ with dst^{-1} aux), ap, fp
        c.append((aux(AUX_TMP0) - flag(F_PC_JNZ) * npc(NPC_MEM_DST))
                 * all_cycles_except_last_zerofier_inv)
        c.append((aux(AUX_TMP1) - aux(AUX_TMP0) * rc(RC_RES))
                 * all_cycles_except_last_zerofier_inv)
        c.append(((one - flag(F_PC_JNZ)) * npc(NPC_PC, 1)
                  + aux(AUX_TMP0) * (npc(NPC_PC, 1)
                                     - (npc(NPC_PC) + npc(NPC_MEM_OP1)))
                  - (flag_pc_update_regular_0 * npc_reg_0
                     + flag(F_PC_JUMP_ABS) * rc(RC_RES)
                     + flag(F_PC_JUMP_REL) * (npc(NPC_PC) + rc(RC_RES))))
                 * all_cycles_except_last_zerofier_inv)
        c.append(((aux(AUX_TMP1) - flag(F_PC_JNZ)) * (npc(NPC_PC, 1) - npc_reg_0))
                 * all_cycles_except_last_zerofier_inv)
        c.append((rc(RC_AP, 1)
                  - (rc(RC_AP) + flag(F_AP_ADD) * rc(RC_RES)
                     + flag(F_AP_ADD1) + flag(F_OPCODE_CALL) * two))
                 * all_cycles_except_last_zerofier_inv)
        c.append((rc(RC_FP, 1)
                  - (fp_update_regular_0 * rc(RC_FP)
                     + flag(F_OPCODE_RET) * npc(NPC_MEM_DST)
                     + flag(F_OPCODE_CALL) * (rc(RC_AP) + two)))
                 * all_cycles_except_last_zerofier_inv)

        # cpu/opcodes: call/ret/assert-eq assertions
        c.append((flag(F_OPCODE_CALL) * (npc(NPC_MEM_DST) - rc(RC_FP)))
                 * all_cycles_zerofier_inv)
        c.append((flag(F_OPCODE_CALL)
                  * (npc(NPC_MEM_OP0) - (npc(NPC_PC) + flag(F_OP1_IMM) + one)))
                 * all_cycles_zerofier_inv)
        c.append((flag(F_OPCODE_CALL) * (rc(RC_OFF_DST) - half_offset_size))
                 * all_cycles_zerofier_inv)
        c.append((flag(F_OPCODE_CALL)
                  * (rc(RC_OFF_OP0) - (half_offset_size + one)))
                 * all_cycles_zerofier_inv)
        c.append((flag(F_OPCODE_CALL)
                  * (flag(F_OPCODE_CALL) + flag(F_OPCODE_CALL) + one + one
                     - (flag(F_DST_REG) + flag(F_OP0_REG) + four)))
                 * all_cycles_zerofier_inv)
        c.append((flag(F_OPCODE_RET)
                  * (rc(RC_OFF_DST) + two - half_offset_size))
                 * all_cycles_zerofier_inv)
        c.append((flag(F_OPCODE_RET)
                  * (rc(RC_OFF_OP1) + one - half_offset_size))
                 * all_cycles_zerofier_inv)
        c.append((flag(F_OPCODE_RET)
                  * (flag(F_PC_JUMP_ABS) + flag(F_DST_REG) + flag(F_OP1_FP)
                     + flag_res_op1_0 - four))
                 * all_cycles_zerofier_inv)
        c.append((flag(F_OPCODE_ASSERT_EQ) * (npc(NPC_MEM_DST) - rc(RC_RES)))
                 * all_cycles_zerofier_inv)

        # boundary: initial/final registers (final_fp == initial_ap, a
        # SHARP/reference convention — plain/air.rs:361-368)
        c.append((rc(RC_AP) - Hint(H_INITIAL_AP)) * first_row_zerofier_inv)
        c.append((rc(RC_FP) - Hint(H_INITIAL_AP)) * first_row_zerofier_inv)
        c.append((npc(NPC_PC) - Hint(H_INITIAL_PC)) * first_row_zerofier_inv)
        c.append((rc(RC_AP) - Hint(H_FINAL_AP)) / last_cycle_zerofier)
        c.append((rc(RC_FP) - Hint(H_INITIAL_AP)) / last_cycle_zerofier)
        c.append((npc(NPC_PC) - Hint(H_FINAL_PC)) / last_cycle_zerofier)

        # memory permutation (Cairo paper 9.7/9.8)
        c.append(((z_mem - (mem(0) + a_mem * mem(1))) * perm_mem(0)
                  + npc(NPC_PC) + a_mem * npc(NPC_INSTRUCTION) - z_mem)
                 * first_row_zerofier_inv)
        c.append(((z_mem - (mem(0, 1) + a_mem * mem(1, 1))) * perm_mem(1)
                  - (z_mem - (npc(NPC_PUBMEM_ADDR) + a_mem * npc(NPC_PUBMEM_VAL)))
                  * perm_mem(0))
                 * every_second_row_except_last_zerofier_inv)
        c.append((perm_mem(0) - Hint(H_MEMORY_PRODUCT))
                 * second_last_row_zerofier_inv)
        c.append((memory_address_diff_0 * memory_address_diff_0
                  - memory_address_diff_0)
                 * every_second_row_except_last_zerofier_inv)
        c.append(((memory_address_diff_0 - one) * (mem(1, 0) - mem(1, 1)))
                 * every_second_row_except_last_zerofier_inv)
        c.append((mem(0) - one) * first_row_zerofier_inv)
        c.append(npc(NPC_PUBMEM_ADDR) * every_eighth_row_zerofier_inv)
        c.append(npc(NPC_PUBMEM_VAL) * every_eighth_row_zerofier_inv)

        # 16-bit range check permutation (Cairo paper 9.9)
        c.append(((z_rc - rc(RC_ORDERED)) * perm_rc(0) + rc(RC_OFF_DST) - z_rc)
                 * first_row_zerofier_inv)
        c.append(((z_rc - rc(RC_ORDERED, 1)) * perm_rc(1)
                  - (z_rc - rc(RC_OFF_OP1)) * perm_rc(0))
                 * every_fourth_row_except_last_zerofier)
        c.append((perm_rc(0) - Hint(H_RC_PRODUCT)) * fourth_last_row_zerofier_inv)
        c.append((rc16_diff_0 * rc16_diff_0 - rc16_diff_0)
                 * every_fourth_row_except_last_zerofier)
        c.append((rc(RC_ORDERED) - Hint(H_RC_MIN)) * first_row_zerofier_inv)
        c.append((rc(RC_ORDERED) - Hint(H_RC_MAX)) * fourth_last_row_zerofier_inv)

        assert len(c) == 47, len(c)
        return c

    @staticmethod
    def gen_hints(trace_len: int, public_input, challenges, field_modulus: int):
        """Verifier-computable hints (plain/air.rs:535-568).

        challenges: list of python ints indexed by challenge id.
        """
        from ..utils import compute_public_memory_quotient
        memory_product = compute_public_memory_quotient(
            challenges[MEMORY_Z], challenges[MEMORY_A], trace_len,
            public_input.public_memory, public_input.public_memory_padding(),
            PUBLIC_MEMORY_STEP, field_modulus)

        hints = [0] * NUM_HINTS
        hints[H_INITIAL_AP] = public_input.initial_ap()
        hints[H_INITIAL_PC] = public_input.initial_pc()
        hints[H_FINAL_AP] = public_input.final_ap()
        hints[H_FINAL_PC] = public_input.final_pc()
        hints[H_MEMORY_PRODUCT] = memory_product
        hints[H_RC_PRODUCT] = 1
        hints[H_RC_MIN] = public_input.rc_min
        hints[H_RC_MAX] = public_input.rc_max
        return hints
