"""Frozen copy of sandstorm_tpu_torch/layouts/recursive/air.py, the constraints
the reference verifier evaluates at the OODS point.

AIR for the `recursive` Cairo layout: 93 constraints over 7 base + 3
extension columns (a copy of sandstorm_tpu/layouts/recursive/air.py over
the port's expression DSL).

Constraint-set and virtual-column parity with the reference sandstorm's
layouts/src/recursive/air.rs (constraint list :1084-1178, column map
:1324-1729, hints :1202-1261), which itself mirrors StarkWare's open-source
verifier for the `recursive` layout.  Expressions are built in the symbolic
DSL (air/expr.py) and evaluated over the LDE domain on the trace's device.

Column map:
  col0 Flags (16 bit-prefixes/cycle)
  col1 DilutedCheck::Unordered (step 1) — doubles as the bitwise dilution
       pool: Bits16Chunk{c}Offset{j} at cell 8c+2j of each 32-row group,
       shifted uniqueness cells at 1/33/65/97 of each 128-row instance
  col2 DilutedCheck::Ordered (step 1)
  col3 Npc — cpu cells per cycle; pub-mem pair at (2,3) step 16; builtin
       memory cells at documented strides (pedersen 2048, rc128 128,
       bitwise pool 32, bitwise x|y 128); gap fill at (14,15)
  col4 Mem (address,value at step 2)
  col5 RangeCheck (offsets cells 0/4/8, ordered step 4 shift 2, rc128
       part cell 12 step 16) + Pedersen partial sums x/y at cells 1/3
       step 4
  col6 Auxiliary (ap/tmp0/op0*op1/fp/tmp1/res at odd cells, step 16) +
       Pedersen suffix/slope at cells 0/2 step 4, bit-unpacking flags at
       cells 7 and 1022 of each 1024-row half-instance
  col7 DilutedCheck::Aggregate (ext, step 1)
  col8 Permutation::DilutedCheck (ext, step 1)
  col9 Permutation::Memory (ext, step 2 shift 0) / RangeCheck (step 4
       shift 1)
"""

import functools

from ...expr import X, Constant, Trace, Challenge, Hint, Periodic
from ... import pedersen as pedersen_builtin
from ...layout_utils import (PeriodicColumn, compute_public_memory_quotient,
                     compute_diluted_cumulative_value)
from . import (CYCLE_HEIGHT, PUBLIC_MEMORY_STEP, MEMORY_STEP,
               RANGE_CHECK_STEP, PEDERSEN_BUILTIN_RATIO,
               RANGE_CHECK_BUILTIN_RATIO, RANGE_CHECK_BUILTIN_PARTS,
               BITWISE_RATIO, DILUTED_CHECK_N_BITS, DILUTED_CHECK_SPACING)

# -- challenges (recursive/air.rs:1755-1807) ----------------------------------
MEMORY_Z = 0
MEMORY_A = 1
RC_Z = 2
DILUTED_PERM_Z = 3
DILUTED_AGG_Z = 4
DILUTED_AGG_A = 5
NUM_CHALLENGES = 6

# -- hints (recursive/air.rs:1731-1747) ---------------------------------------
H_INITIAL_AP = 0
H_INITIAL_PC = 1
H_FINAL_AP = 2
H_FINAL_PC = 3
H_MEMORY_QUOTIENT = 4
H_RC_PRODUCT = 5
H_RC_MIN = 6
H_RC_MAX = 7
H_DILUTED_PRODUCT = 8
H_DILUTED_FIRST = 9
H_DILUTED_CUMULATIVE = 10
H_INITIAL_PEDERSEN_ADDR = 11
H_INITIAL_RC_ADDR = 12
H_INITIAL_BITWISE_ADDR = 13
NUM_HINTS = 14

# flag bit indices (same semantics as the plain layout / binary.word)
F_DST_REG, F_OP0_REG, F_OP1_IMM, F_OP1_FP, F_OP1_AP = 0, 1, 2, 3, 4
F_RES_ADD, F_RES_MUL = 5, 6
F_PC_JUMP_ABS, F_PC_JUMP_REL, F_PC_JNZ = 7, 8, 9
F_AP_ADD, F_AP_ADD1 = 10, 11
F_OPCODE_CALL, F_OPCODE_RET, F_OPCODE_ASSERT_EQ = 12, 13, 14
F_ZERO = 15

# Npc cells (recursive/air.rs:1486-1572)
NPC_PC, NPC_INSTRUCTION = 0, 1
NPC_PUBMEM_ADDR, NPC_PUBMEM_VAL = 2, 3
NPC_MEM_OP0_ADDR, NPC_MEM_OP0 = 4, 5
NPC_MEM_DST_ADDR, NPC_MEM_DST = 8, 9
NPC_MEM_OP1_ADDR, NPC_MEM_OP1 = 12, 13
NPC_UNUSED_ADDR, NPC_UNUSED_VAL = 14, 15
NPC_PEDERSEN_IN0_ADDR, NPC_PEDERSEN_IN0_VAL = 10, 11
NPC_PEDERSEN_OUT_ADDR, NPC_PEDERSEN_OUT_VAL = 522, 523
NPC_PEDERSEN_IN1_ADDR, NPC_PEDERSEN_IN1_VAL = 1034, 1035
NPC_RC128_ADDR, NPC_RC128_VAL = 74, 75
NPC_BITWISE_POOL_ADDR, NPC_BITWISE_POOL_VAL = 26, 27
NPC_BITWISE_XORY_ADDR, NPC_BITWISE_XORY_VAL = 42, 43

# RangeCheck column cells (recursive/air.rs:1636-1665)
RC_OFF_DST, RC_ORDERED, RC_OFF_OP1, RC_OFF_OP0, RC_UNUSED = 0, 2, 4, 8, 12
RC16_COMPONENT = 12  # step 16 (RC ratio 8 * 16 / 8 parts)

# Auxiliary column cells (recursive/air.rs:1667-1693)
AUX_AP, AUX_TMP0, AUX_OP0_MUL_OP1, AUX_FP, AUX_TMP1, AUX_RES = 1, 3, 5, 9, 11, 13

# Pedersen cells (recursive/air.rs:1453-1484)
PED_SUFFIX, PED_SLOPE = 0, 2                   # col6, step 4
PED_PSUM_X, PED_PSUM_Y = 1, 3                  # col5, step 4
PED_BIT251_196_192, PED_BIT251_196 = 7, 1022   # col6, step 1024

# Bitwise shifted-uniqueness cells of col1 (recursive/air.rs:1383-1396)
BITWISE_RES_SHIFTED = (1, 65, 33, 97)          # offsets 0..3, step 128

# periodic column registry indices
P_PEDERSEN_X, P_PEDERSEN_Y = 0, 1

PEDERSEN_STEP_ROWS = PEDERSEN_BUILTIN_RATIO * CYCLE_HEIGHT  # 2048
BITWISE_STEP_ROWS = BITWISE_RATIO * CYCLE_HEIGHT            # 128
RC128_STEP_ROWS = RANGE_CHECK_BUILTIN_RATIO * CYCLE_HEIGHT  # 128


def flag(bit, cycle_offset=0):
    off = CYCLE_HEIGHT * cycle_offset + bit
    return Trace(0, off) - 2 * Trace(0, off + 1)


def npc(cell, offset=0):
    if cell in (NPC_PUBMEM_ADDR, NPC_PUBMEM_VAL):
        step = PUBLIC_MEMORY_STEP
    elif cell in (NPC_PEDERSEN_IN0_ADDR, NPC_PEDERSEN_IN0_VAL,
                  NPC_PEDERSEN_IN1_ADDR, NPC_PEDERSEN_IN1_VAL,
                  NPC_PEDERSEN_OUT_ADDR, NPC_PEDERSEN_OUT_VAL):
        step = PEDERSEN_STEP_ROWS
    elif cell in (NPC_RC128_ADDR, NPC_RC128_VAL):
        step = RC128_STEP_ROWS
    elif cell in (NPC_BITWISE_POOL_ADDR, NPC_BITWISE_POOL_VAL):
        step = BITWISE_STEP_ROWS // 4
    elif cell in (NPC_BITWISE_XORY_ADDR, NPC_BITWISE_XORY_VAL):
        step = BITWISE_STEP_ROWS
    else:
        step = CYCLE_HEIGHT
    return Trace(3, step * offset + cell)


def mem(cell, offset=0):
    return Trace(4, MEMORY_STEP * offset + cell)


def rc(cell, offset=0):
    step = RANGE_CHECK_STEP if cell == RC_ORDERED else CYCLE_HEIGHT
    return Trace(5, step * offset + cell)


def rc16_component(offset=0):
    return Trace(5, 16 * offset + RC16_COMPONENT)


def aux(cell, offset=0):
    return Trace(6, CYCLE_HEIGHT * offset + cell)


def ped_suffix(offset=0):
    return Trace(6, 4 * offset + PED_SUFFIX)


def ped_slope(offset=0):
    return Trace(6, 4 * offset + PED_SLOPE)


def ped_psum_x(offset=0):
    return Trace(5, 4 * offset + PED_PSUM_X)


def ped_psum_y(offset=0):
    return Trace(5, 4 * offset + PED_PSUM_Y)


def ped_bits(cell, offset=0):
    return Trace(6, (PEDERSEN_STEP_ROWS // 2) * offset + cell)


def bitwise_chunk(chunk, spacing_offset, offset=0):
    """Bits16Chunk{chunk}Offset{j} at cell 8*chunk+2*j, step 32."""
    return Trace(1, 32 * offset + 8 * chunk + 2 * spacing_offset)


def bitwise_res_shifted(spacing_offset, offset=0):
    return Trace(1, 128 * offset + BITWISE_RES_SHIFTED[spacing_offset])


def diluted_unordered(offset=0):
    return Trace(1, offset)


def diluted_ordered(offset=0):
    return Trace(2, offset)


def diluted_aggregate(offset=0):
    return Trace(7, offset)


def perm_diluted(offset=0):
    return Trace(8, offset)


def perm_mem(offset=0):
    return Trace(9, MEMORY_STEP * offset + 0)


def perm_rc(offset=0):
    return Trace(9, RANGE_CHECK_STEP * offset + 1)


@functools.lru_cache(maxsize=1)
def _pedersen_periodic_columns():
    """Pedersen doubling-chain point tables as periodic columns.

    The 512-row table (x and y coordinates of the successively doubled
    P1..P4 hash points; layout documented in the reference sandstorm's
    pedersen/periodic.rs:5-70 and recursive/air.rs:722-783) is interpolated
    over the 512th roots at runtime, the analog of the reference's baked
    HASH_POINTS_{X,Y}_COEFFS constants.
    """
    from ...field import Fp252
    p = Fp252.MODULUS
    root = Fp252.root_of_unity_int(512)
    pts = (pedersen_builtin.periodic_table_points(0)
           + pedersen_builtin.periodic_table_points(1))
    assert len(pts) == 512
    xs = [pt[0] for pt in pts]
    ys = [pt[1] for pt in pts]
    return (PeriodicColumn.from_table(xs, PEDERSEN_STEP_ROWS, p, root),
            PeriodicColumn.from_table(ys, PEDERSEN_STEP_ROWS, p, root))


class RecursiveAirConfig:
    """Recursive-layout AirConfig (recursive/air.rs:52-1262)."""

    NUM_BASE_COLUMNS = 7
    NUM_EXTENSION_COLUMNS = 3
    NUM_CHALLENGES = NUM_CHALLENGES
    NUM_HINTS = NUM_HINTS
    CE_BLOWUP_FACTOR = 2
    CYCLE_HEIGHT = CYCLE_HEIGHT
    PUBLIC_MEMORY_STEP = PUBLIC_MEMORY_STEP

    @staticmethod
    def periodic_columns(trace_len: int):
        px, py = _pedersen_periodic_columns()
        return [px.bind(trace_len), py.bind(trace_len)]

    @staticmethod
    def constraints(trace_len: int, field_modulus: int, trace_gen: int,
                    base_modulus: int = None):
        n = trace_len
        g = trace_gen
        p = field_modulus
        # domain constants (powers of the base-field trace generator) are
        # reduced mod the BASE modulus: for extension fields the packed
        # encoding is not the integer ring mod the field order
        pb = base_modulus or p
        assert n % (2 * PEDERSEN_STEP_ROWS) == 0, \
            "recursive layout requires trace_len % 4096 == 0"

        one = Constant(1)
        two = Constant(2)
        four = Constant(4)
        offset_size = Constant(1 << 16)
        half_offset_size = Constant(1 << 15)

        z_mem = Challenge(MEMORY_Z)
        a_mem = Challenge(MEMORY_A)
        z_rc = Challenge(RC_Z)
        z_dp = Challenge(DILUTED_PERM_Z)
        z_da = Challenge(DILUTED_AGG_Z)
        a_da = Challenge(DILUTED_AGG_A)

        # -- composite flag groups ------------------------------------------
        f_op1_base_op0 = one - (flag(F_OP1_IMM) + flag(F_OP1_AP) + flag(F_OP1_FP))
        f_res_op1 = one - (flag(F_RES_ADD) + flag(F_RES_MUL) + flag(F_PC_JNZ))
        f_pc_update_regular = \
            one - (flag(F_PC_JUMP_ABS) + flag(F_PC_JUMP_REL) + flag(F_PC_JNZ))
        f_fp_update_regular = one - (flag(F_OPCODE_CALL) + flag(F_OPCODE_RET))

        npc_reg_0 = npc(NPC_PC) + flag(F_OP1_IMM) + one
        memory_address_diff_0 = mem(0, 1) - mem(0, 0)
        rc16_diff_0 = rc(RC_ORDERED, 1) - rc(RC_ORDERED, 0)
        pedersen_b0 = ped_suffix(0) - (ped_suffix(1) + ped_suffix(1))
        pedersen_b0_neg = one - pedersen_b0

        # 128-bit rc builtin recomposition from 8 big-endian u16 parts
        rc_value = rc16_component(0)
        for k in range(1, RANGE_CHECK_BUILTIN_PARTS):
            rc_value = rc_value * offset_size + rc16_component(k)

        # bitwise recomposition of bits 0..127 and 128..255
        bitwise_sum_var_0_0 = bitwise_chunk(0, 0)
        for j in range(1, 4):
            bitwise_sum_var_0_0 = \
                bitwise_sum_var_0_0 + bitwise_chunk(0, j) * Constant(1 << j)
        for j in range(4):
            bitwise_sum_var_0_0 = \
                bitwise_sum_var_0_0 + bitwise_chunk(1, j) * Constant(1 << (64 + j))
        bitwise_sum_var_8_0 = bitwise_chunk(2, 0) * Constant(1 << 128)
        for j in range(1, 4):
            bitwise_sum_var_8_0 = \
                bitwise_sum_var_8_0 + bitwise_chunk(2, j) * Constant(1 << (128 + j))
        for j in range(4):
            bitwise_sum_var_8_0 = \
                bitwise_sum_var_8_0 + bitwise_chunk(3, j) * Constant(1 << (192 + j))

        # -- zerofiers --------------------------------------------------------
        flag0_offset = Constant(pow(g, F_ZERO * n // CYCLE_HEIGHT, pb))
        flag0_zerofier = X.pow(n // CYCLE_HEIGHT) - flag0_offset
        every_row_zerofier = X.pow(n) - one
        flags_zerofier_inv = flag0_zerofier / every_row_zerofier
        all_cycles_zerofier_inv = one / (X.pow(n // CYCLE_HEIGHT) - one)
        last_cycle_zerofier = X - Constant(
            pow(g, CYCLE_HEIGHT * (n // CYCLE_HEIGHT - 1), pb))
        last_cycle_zerofier_inv = one / last_cycle_zerofier
        all_cycles_except_last_zerofier_inv = \
            last_cycle_zerofier * all_cycles_zerofier_inv
        first_row_zerofier_inv = one / (X - one)

        every_second_row_zerofier = X.pow(n // 2) - one
        second_last_row_zerofier = X - Constant(pow(g, 2 * (n // 2 - 1), pb))
        every_second_row_except_last_zerofier_inv = \
            second_last_row_zerofier / every_second_row_zerofier
        second_last_row_zerofier_inv = one / second_last_row_zerofier

        every_fourth_row_zerofier_inv = one / (X.pow(n // 4) - one)
        fourth_last_row_zerofier = X - Constant(pow(g, 4 * (n // 4 - 1), pb))
        fourth_last_row_zerofier_inv = one / fourth_last_row_zerofier
        every_fourth_row_except_last_zerofier_inv = \
            fourth_last_row_zerofier * every_fourth_row_zerofier_inv

        last_row_zerofier = X - Constant(pow(g, n - 1, pb))
        last_row_zerofier_inv = one / last_row_zerofier
        every_row_except_last_zerofier_inv = \
            last_row_zerofier / every_row_zerofier

        every_1024_row_zerofier_inv = one / (X.pow(n // 1024) - one)
        pedersen_transition_zerofier_inv = \
            (X.pow(n // 1024) - Constant(pow(g, 255 * n // 256, pb))) \
            * every_fourth_row_zerofier_inv
        pedersen_zero_suffix_zerofier_inv = \
            one / (X.pow(n // 1024) - Constant(pow(g, 63 * n // 64, pb)))
        pedersen_zeros_tail_zerofier_inv = \
            one / (X.pow(n // 1024) - Constant(pow(g, 255 * n // 256, pb)))
        pedersen_copy_zerofier_inv = \
            (X.pow(n // 2048) - Constant(pow(g, n // 2, pb))) \
            * every_1024_row_zerofier_inv
        every_2048_row_zerofier_inv = one / (X.pow(n // 2048) - one)
        every_2048_rows_except_last_zerofier = \
            (X - Constant(pow(g, 2048 * (n // 2048 - 1), pb))) \
            * every_2048_row_zerofier_inv

        every_128_rows_zerofier_inv = one / (X.pow(n // 128) - one)
        every_128_rows_except_last_zerofier = \
            (X - Constant(pow(g, 128 * (n // 128 - 1), pb))) \
            * every_128_rows_zerofier_inv

        every_32_row_zerofier_inv = one / (X.pow(n // 32) - one)
        bitwise_transition_zerofier_inv = \
            (X.pow(n // 128) - Constant(pow(g, 3 * n // 4, pb))) \
            * every_32_row_zerofier_inv
        all_bitwise_zerofier = X.pow(n // 128) - one
        all_bitwise_zerofier_inv = one / all_bitwise_zerofier
        all_bitwise_except_last_zerofier_inv = \
            (X - Constant(pow(g, 128 * (n // 128 - 1), pb))) \
            * all_bitwise_zerofier_inv
        # vanishes on the 15 shifted 16-row segment groups + base group of
        # every 128-row window (hand-built zerofier, recursive/air.rs:1027-1044)
        seg = all_bitwise_zerofier
        for k in range(1, 16):
            seg = seg * (X.pow(n // 128) - Constant(pow(g, k * n // 64, pb)))
        every_16_bit_segment_zerofier_inv = one / seg

        pedersen_point_x = Periodic(P_PEDERSEN_X)
        pedersen_point_y = Periodic(P_PEDERSEN_Y)
        shift_point = pedersen_builtin.shift_and_table_points()[0]

        c = []

        # -- cpu/decode (recursive/air.rs:158-213) ---------------------------
        c.append((flag(F_DST_REG) * flag(F_DST_REG) - flag(F_DST_REG))
                 * flags_zerofier_inv)
        c.append(Trace(0, 0) / flag0_zerofier)
        c.append((npc(NPC_INSTRUCTION)
                  - (((Trace(0, 0) * offset_size + rc(RC_OFF_OP1)) * offset_size
                      + rc(RC_OFF_OP0)) * offset_size + rc(RC_OFF_DST)))
                 * all_cycles_zerofier_inv)
        for grp in (f_op1_base_op0, f_res_op1, f_pc_update_regular,
                    f_fp_update_regular):
            c.append((grp * grp - grp) * all_cycles_zerofier_inv)

        # -- cpu/operands ------------------------------------------------------
        c.append((npc(NPC_MEM_DST_ADDR) + half_offset_size
                  - (flag(F_DST_REG) * aux(AUX_FP)
                     + (one - flag(F_DST_REG)) * aux(AUX_AP)
                     + rc(RC_OFF_DST))) * all_cycles_zerofier_inv)
        c.append((npc(NPC_MEM_OP0_ADDR) + half_offset_size
                  - (flag(F_OP0_REG) * aux(AUX_FP)
                     + (one - flag(F_OP0_REG)) * aux(AUX_AP)
                     + rc(RC_OFF_OP0))) * all_cycles_zerofier_inv)
        c.append((npc(NPC_MEM_OP1_ADDR) + half_offset_size
                  - (flag(F_OP1_IMM) * npc(NPC_PC)
                     + flag(F_OP1_AP) * aux(AUX_AP)
                     + flag(F_OP1_FP) * aux(AUX_FP)
                     + f_op1_base_op0 * npc(NPC_MEM_OP0)
                     + rc(RC_OFF_OP1))) * all_cycles_zerofier_inv)
        c.append((aux(AUX_OP0_MUL_OP1) - npc(NPC_MEM_OP0) * npc(NPC_MEM_OP1))
                 * all_cycles_zerofier_inv)
        c.append(((one - flag(F_PC_JNZ)) * aux(AUX_RES)
                  - (flag(F_RES_ADD) * (npc(NPC_MEM_OP0) + npc(NPC_MEM_OP1))
                     + flag(F_RES_MUL) * aux(AUX_OP0_MUL_OP1)
                     + f_res_op1 * npc(NPC_MEM_OP1)))
                 * all_cycles_zerofier_inv)

        # -- cpu/update_registers ---------------------------------------------
        c.append((aux(AUX_TMP0) - flag(F_PC_JNZ) * npc(NPC_MEM_DST))
                 * all_cycles_except_last_zerofier_inv)
        c.append((aux(AUX_TMP1) - aux(AUX_TMP0) * aux(AUX_RES))
                 * all_cycles_except_last_zerofier_inv)
        c.append(((one - flag(F_PC_JNZ)) * npc(NPC_PC, 1)
                  + aux(AUX_TMP0) * (npc(NPC_PC, 1)
                                     - (npc(NPC_PC) + npc(NPC_MEM_OP1)))
                  - (f_pc_update_regular * npc_reg_0
                     + flag(F_PC_JUMP_ABS) * aux(AUX_RES)
                     + flag(F_PC_JUMP_REL) * (npc(NPC_PC) + aux(AUX_RES))))
                 * all_cycles_except_last_zerofier_inv)
        c.append(((aux(AUX_TMP1) - flag(F_PC_JNZ)) * (npc(NPC_PC, 1) - npc_reg_0))
                 * all_cycles_except_last_zerofier_inv)
        c.append((aux(AUX_AP, 1)
                  - (aux(AUX_AP) + flag(F_AP_ADD) * aux(AUX_RES)
                     + flag(F_AP_ADD1) + flag(F_OPCODE_CALL) * two))
                 * all_cycles_except_last_zerofier_inv)
        c.append((aux(AUX_FP, 1)
                  - (f_fp_update_regular * aux(AUX_FP)
                     + flag(F_OPCODE_RET) * npc(NPC_MEM_DST)
                     + flag(F_OPCODE_CALL) * (aux(AUX_AP) + two)))
                 * all_cycles_except_last_zerofier_inv)

        # -- cpu/opcodes --------------------------------------------------------
        c.append((flag(F_OPCODE_CALL) * (npc(NPC_MEM_DST) - aux(AUX_FP)))
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
                     + f_res_op1 - four))
                 * all_cycles_zerofier_inv)
        c.append((flag(F_OPCODE_ASSERT_EQ) * (npc(NPC_MEM_DST) - aux(AUX_RES)))
                 * all_cycles_zerofier_inv)

        # -- boundary ----------------------------------------------------------
        c.append((aux(AUX_AP) - Hint(H_INITIAL_AP)) * first_row_zerofier_inv)
        c.append((aux(AUX_FP) - Hint(H_INITIAL_AP)) * first_row_zerofier_inv)
        c.append((npc(NPC_PC) - Hint(H_INITIAL_PC)) * first_row_zerofier_inv)
        c.append((aux(AUX_AP) - Hint(H_FINAL_AP)) * last_cycle_zerofier_inv)
        c.append((aux(AUX_FP) - Hint(H_INITIAL_AP)) * last_cycle_zerofier_inv)
        c.append((npc(NPC_PC) - Hint(H_FINAL_PC)) * last_cycle_zerofier_inv)

        # -- memory permutation --------------------------------------------------
        c.append(((z_mem - (mem(0) + a_mem * mem(1))) * perm_mem(0)
                  + npc(NPC_PC) + a_mem * npc(NPC_INSTRUCTION) - z_mem)
                 * first_row_zerofier_inv)
        c.append(((z_mem - (mem(0, 1) + a_mem * mem(1, 1))) * perm_mem(1)
                  - (z_mem - (npc(NPC_PUBMEM_ADDR) + a_mem * npc(NPC_PUBMEM_VAL)))
                  * perm_mem(0))
                 * every_second_row_except_last_zerofier_inv)
        c.append((perm_mem(0) - Hint(H_MEMORY_QUOTIENT))
                 * second_last_row_zerofier_inv)
        c.append((memory_address_diff_0 * memory_address_diff_0
                  - memory_address_diff_0)
                 * every_second_row_except_last_zerofier_inv)
        c.append(((memory_address_diff_0 - one) * (mem(1, 0) - mem(1, 1)))
                 * every_second_row_except_last_zerofier_inv)
        c.append((mem(0) - one) * first_row_zerofier_inv)
        c.append(npc(NPC_PUBMEM_ADDR) * all_cycles_zerofier_inv)
        c.append(npc(NPC_PUBMEM_VAL) * all_cycles_zerofier_inv)

        # -- 16-bit range-check permutation ---------------------------------------
        c.append(((z_rc - rc(RC_ORDERED)) * perm_rc(0) + rc(RC_OFF_DST) - z_rc)
                 * first_row_zerofier_inv)
        c.append(((z_rc - rc(RC_ORDERED, 1)) * perm_rc(1)
                  - (z_rc - rc(RC_OFF_OP1)) * perm_rc(0))
                 * every_fourth_row_except_last_zerofier_inv)
        c.append((perm_rc(0) - Hint(H_RC_PRODUCT)) * fourth_last_row_zerofier_inv)
        c.append((rc16_diff_0 * rc16_diff_0 - rc16_diff_0)
                 * every_fourth_row_except_last_zerofier_inv)
        c.append((rc(RC_ORDERED) - Hint(H_RC_MIN)) * first_row_zerofier_inv)
        c.append((rc(RC_ORDERED) - Hint(H_RC_MAX)) * fourth_last_row_zerofier_inv)

        # -- diluted check (permutation + aggregation) -----------------------------
        c.append(((z_dp - diluted_ordered(0)) * perm_diluted(0)
                  + diluted_unordered(0) - z_dp) * first_row_zerofier_inv)
        c.append(((z_dp - diluted_ordered(1)) * perm_diluted(1)
                  - (z_dp - diluted_unordered(1)) * perm_diluted(0))
                 * every_row_except_last_zerofier_inv)
        c.append((perm_diluted(0) - Hint(H_DILUTED_PRODUCT))
                 * last_row_zerofier_inv)
        c.append((diluted_aggregate(0) - one) * first_row_zerofier_inv)
        c.append((diluted_ordered(0) - Hint(H_DILUTED_FIRST))
                 * first_row_zerofier_inv)
        diluted_diff = diluted_ordered(1) - diluted_ordered(0)
        c.append((diluted_aggregate(1)
                  - (diluted_aggregate(0) * (one + z_da * diluted_diff)
                     + a_da * diluted_diff * diluted_diff))
                 * every_row_except_last_zerofier_inv)
        c.append((diluted_aggregate(0) - Hint(H_DILUTED_CUMULATIVE))
                 * last_row_zerofier_inv)

        # -- pedersen builtin: unique bit unpacking (recursive/air.rs:610-651) ----
        c.append((ped_bits(PED_BIT251_196_192)
                  * (ped_suffix(0) - (ped_suffix(1) + ped_suffix(1))))
                 * every_1024_row_zerofier_inv)
        c.append((ped_bits(PED_BIT251_196_192)
                  * (ped_suffix(1) - ped_suffix(192) * Constant(1 << 191)))
                 * every_1024_row_zerofier_inv)
        c.append((ped_bits(PED_BIT251_196_192)
                  - ped_bits(PED_BIT251_196)
                  * (ped_suffix(192) - (ped_suffix(193) + ped_suffix(193))))
                 * every_1024_row_zerofier_inv)
        c.append((ped_bits(PED_BIT251_196)
                  * (ped_suffix(193) - ped_suffix(196) * Constant(8)))
                 * every_1024_row_zerofier_inv)
        c.append((ped_bits(PED_BIT251_196)
                  - (ped_suffix(251) - (ped_suffix(252) + ped_suffix(252)))
                  * (ped_suffix(196) - (ped_suffix(197) + ped_suffix(197))))
                 * every_1024_row_zerofier_inv)
        c.append(((ped_suffix(251) - (ped_suffix(252) + ped_suffix(252)))
                  * (ped_suffix(197) - ped_suffix(251) * Constant(1 << 54)))
                 * every_1024_row_zerofier_inv)

        # -- pedersen: EC subset-sum (recursive/air.rs:676-819) --------------------
        c.append((pedersen_b0 * (pedersen_b0 - one))
                 * pedersen_transition_zerofier_inv)
        c.append(ped_suffix(0) * pedersen_zero_suffix_zerofier_inv)
        c.append(ped_suffix(0) * pedersen_zeros_tail_zerofier_inv)
        c.append((pedersen_b0 * (ped_psum_y(0) - pedersen_point_y)
                  - ped_slope(0) * (ped_psum_x(0) - pedersen_point_x))
                 * pedersen_transition_zerofier_inv)
        c.append((ped_slope(0) * ped_slope(0)
                  - pedersen_b0 * (ped_psum_x(0) + pedersen_point_x
                                   + ped_psum_x(1)))
                 * pedersen_transition_zerofier_inv)
        c.append((pedersen_b0 * (ped_psum_y(0) + ped_psum_y(1))
                  - ped_slope(0) * (ped_psum_x(0) - ped_psum_x(1)))
                 * pedersen_transition_zerofier_inv)
        c.append((pedersen_b0_neg * (ped_psum_x(1) - ped_psum_x(0)))
                 * pedersen_transition_zerofier_inv)
        c.append((pedersen_b0_neg * (ped_psum_y(1) - ped_psum_y(0)))
                 * pedersen_transition_zerofier_inv)
        c.append((ped_psum_x(256) - ped_psum_x(255)) * pedersen_copy_zerofier_inv)
        c.append((ped_psum_y(256) - ped_psum_y(255)) * pedersen_copy_zerofier_inv)
        c.append((ped_psum_x(0) - Constant(shift_point[0]))
                 * every_2048_row_zerofier_inv)
        c.append((ped_psum_y(0) - Constant(shift_point[1]))
                 * every_2048_row_zerofier_inv)

        # -- pedersen: memory links (recursive/air.rs:868-895) ---------------------
        c.append((npc(NPC_PEDERSEN_IN0_VAL) - ped_suffix(0))
                 * every_2048_row_zerofier_inv)
        c.append((npc(NPC_PEDERSEN_IN0_ADDR, 1)
                  - (npc(NPC_PEDERSEN_OUT_ADDR) + one))
                 * every_2048_rows_except_last_zerofier)
        c.append((npc(NPC_PEDERSEN_IN0_ADDR) - Hint(H_INITIAL_PEDERSEN_ADDR))
                 * first_row_zerofier_inv)
        c.append((npc(NPC_PEDERSEN_IN1_VAL) - ped_suffix(256))
                 * every_2048_row_zerofier_inv)
        c.append((npc(NPC_PEDERSEN_IN1_ADDR)
                  - (npc(NPC_PEDERSEN_IN0_ADDR) + one))
                 * every_2048_row_zerofier_inv)
        c.append((npc(NPC_PEDERSEN_OUT_VAL) - ped_psum_x(511))
                 * every_2048_row_zerofier_inv)
        c.append((npc(NPC_PEDERSEN_OUT_ADDR)
                  - (npc(NPC_PEDERSEN_IN1_ADDR) + one))
                 * every_2048_row_zerofier_inv)

        # -- 128-bit range-check builtin (recursive/air.rs:897-917) ----------------
        c.append((rc_value - npc(NPC_RC128_VAL)) * every_128_rows_zerofier_inv)
        c.append((npc(NPC_RC128_ADDR, 1) - (npc(NPC_RC128_ADDR) + one))
                 * every_128_rows_except_last_zerofier)
        c.append((npc(NPC_RC128_ADDR) - Hint(H_INITIAL_RC_ADDR))
                 * first_row_zerofier_inv)

        # -- bitwise builtin (recursive/air.rs:919-1081) ----------------------------
        c.append((npc(NPC_BITWISE_POOL_ADDR) - Hint(H_INITIAL_BITWISE_ADDR))
                 * first_row_zerofier_inv)
        c.append((npc(NPC_BITWISE_POOL_ADDR, 1)
                  - (npc(NPC_BITWISE_POOL_ADDR) + one))
                 * bitwise_transition_zerofier_inv)
        c.append((npc(NPC_BITWISE_XORY_ADDR)
                  - (npc(NPC_BITWISE_POOL_ADDR, 3) + one))
                 * all_bitwise_zerofier_inv)
        c.append((npc(NPC_BITWISE_POOL_ADDR, 4)
                  - (npc(NPC_BITWISE_XORY_ADDR) + one))
                 * all_bitwise_except_last_zerofier_inv)
        c.append((bitwise_sum_var_0_0 + bitwise_sum_var_8_0
                  - npc(NPC_BITWISE_POOL_VAL))
                 * every_32_row_zerofier_inv)
        c.append((npc(NPC_BITWISE_XORY_VAL)
                  - (npc(NPC_BITWISE_POOL_VAL, 2) + npc(NPC_BITWISE_POOL_VAL, 3)))
                 * all_bitwise_zerofier_inv)
        c.append((bitwise_chunk(0, 0, 0) + bitwise_chunk(0, 0, 1)
                  - (bitwise_chunk(0, 0, 3) + bitwise_chunk(0, 0, 2)
                     + bitwise_chunk(0, 0, 2)))
                 * every_16_bit_segment_zerofier_inv)
        for j in range(4):
            shift = Constant(1 << (8 if j == 3 else 4))
            c.append(((bitwise_chunk(3, j, 2) + bitwise_chunk(3, j, 3)) * shift
                      - bitwise_res_shifted(j))
                     * all_bitwise_zerofier_inv)

        assert len(c) == 93, len(c)
        return c

    @staticmethod
    def gen_hints(trace_len: int, public_input, challenges, field_modulus: int):
        """Verifier-computable hints (recursive/air.rs:1202-1261)."""
        p = field_modulus
        segments = public_input.memory_segments
        memory_quotient = compute_public_memory_quotient(
            challenges[MEMORY_Z], challenges[MEMORY_A], trace_len,
            public_input.public_memory,
            public_input.public_memory_padding(), PUBLIC_MEMORY_STEP, p)
        diluted_cumulative = compute_diluted_cumulative_value(
            challenges[DILUTED_AGG_Z], challenges[DILUTED_AGG_A],
            DILUTED_CHECK_N_BITS, DILUTED_CHECK_SPACING, p)

        hints = [0] * NUM_HINTS
        hints[H_INITIAL_AP] = public_input.initial_ap()
        hints[H_INITIAL_PC] = public_input.initial_pc()
        hints[H_FINAL_AP] = public_input.final_ap()
        hints[H_FINAL_PC] = public_input.final_pc()
        hints[H_MEMORY_QUOTIENT] = memory_quotient
        hints[H_RC_PRODUCT] = 1
        hints[H_RC_MIN] = public_input.rc_min
        hints[H_RC_MAX] = public_input.rc_max
        hints[H_DILUTED_PRODUCT] = 1
        hints[H_DILUTED_FIRST] = 0
        hints[H_DILUTED_CUMULATIVE] = diluted_cumulative
        hints[H_INITIAL_PEDERSEN_ADDR] = segments["pedersen"].begin_addr
        hints[H_INITIAL_RC_ADDR] = segments["range_check"].begin_addr
        hints[H_INITIAL_BITWISE_ADDR] = segments["bitwise"].begin_addr
        return hints
