"""Frozen copy of sandstorm_tpu_torch/layouts/starknet/air.py, the constraints
the reference verifier evaluates at the OODS point.

AIR for the `starknet` Cairo layout: 195 constraints over 9 base + 1
extension column (a copy of sandstorm_tpu/layouts/starknet/air.py over the
port's expression DSL).

Constraint-set and virtual-column parity with the reference sandstorm's
layouts/src/starknet/air.rs (constraint list :2188-2384, column map
:2479-3241, hints :2408-2476).  Adds to the recursive layout's families:
the full ECDSA signature-verification constraints (pubkey doubling,
generator/key exponentiation, result addition, r extraction, nonzero and
on-curve checks), the EC-op builtin (q doubling + r = p + m*q subset sum
with m bit unpacking), and the Poseidon builtin (optimized Hades variant:
3 full-round state machines, 2 partial-round columns, margin transfer
constraints with StarkWare's public verifier constants).

Column map:
  col0 Flags; col1-4 Pedersen PartialSumX/PartialSumY/Suffix/Slope (step 1;
  bit-196 flag at col4 cell 255/256-group, bit-192 flag at col8 cell
  71/256-group); col5 Npc (pub-mem pairs at (2,3) step 8; builtin memory
  cells at (6,7) mod 16 at their strides); col6 Mem; col7 RangeCheck
  (offsets / ordered / rc128 part cell 12 step 32) + DilutedCheck
  unordered cell 1 / ordered cell 5 (step 8) + bitwise dilution chunks
  (cell 1+64c+16j step 256, shifted cells 9/521/265/777 step 1024) +
  Poseidon partial-round state0 cells 3/7 step 8; col8 Auxiliary (even
  cells step 16) + ECDSA/EC-op/Poseidon cells (odd cells at steps
  64/128/16384/32768); col9 (ext) permutations: Memory (cell 0 step 2),
  RangeCheck (cell 1 step 4), DilutedCheck aggregate (cell 3 step 8),
  DilutedCheck permutation (cell 7 step 8).
"""

import functools

from ...expr import X, Constant, Trace, Challenge, Hint, Periodic
from ... import pedersen as pedersen_builtin
from ... import poseidon as poseidon_builtin
from ... import curve as curve_mod
from ...layout_utils import (PeriodicColumn, compute_public_memory_quotient,
                     compute_diluted_cumulative_value)
from . import (CYCLE_HEIGHT, PUBLIC_MEMORY_STEP, MEMORY_STEP,
               RANGE_CHECK_STEP, DILUTED_CHECK_STEP, PEDERSEN_BUILTIN_RATIO,
               RANGE_CHECK_BUILTIN_RATIO, RANGE_CHECK_BUILTIN_PARTS,
               BITWISE_RATIO, ECDSA_BUILTIN_RATIO, EC_OP_BUILTIN_RATIO,
               EC_OP_SCALAR_HEIGHT, POSEIDON_RATIO,
               DILUTED_CHECK_N_BITS, DILUTED_CHECK_SPACING)

# -- challenges / hints (starknet/air.rs:3243-3322) ---------------------------
MEMORY_Z, MEMORY_A, RC_Z = 0, 1, 2
DILUTED_PERM_Z, DILUTED_AGG_Z, DILUTED_AGG_A = 3, 4, 5
NUM_CHALLENGES = 6

(H_INITIAL_AP, H_INITIAL_PC, H_FINAL_AP, H_FINAL_PC, H_MEMORY_QUOTIENT,
 H_RC_PRODUCT, H_RC_MIN, H_RC_MAX, H_DILUTED_PRODUCT, H_DILUTED_FIRST,
 H_DILUTED_CUMULATIVE, H_INITIAL_PEDERSEN_ADDR, H_INITIAL_RC_ADDR,
 H_INITIAL_ECDSA_ADDR, H_INITIAL_BITWISE_ADDR, H_INITIAL_EC_OP_ADDR,
 H_INITIAL_POSEIDON_ADDR) = range(17)
NUM_HINTS = 17

# flag bits
F_DST_REG, F_OP0_REG, F_OP1_IMM, F_OP1_FP, F_OP1_AP = 0, 1, 2, 3, 4
F_RES_ADD, F_RES_MUL = 5, 6
F_PC_JUMP_ABS, F_PC_JUMP_REL, F_PC_JNZ = 7, 8, 9
F_AP_ADD, F_AP_ADD1 = 10, 11
F_OPCODE_CALL, F_OPCODE_RET, F_OPCODE_ASSERT_EQ = 12, 13, 14
F_ZERO = 15

# Npc cells (starknet/air.rs:2913-3101); builtin cells all (6,7) mod 16
NPC_PC, NPC_INSTRUCTION = 0, 1
NPC_PUBMEM_ADDR, NPC_PUBMEM_VAL = 2, 3
NPC_MEM_OP0_ADDR, NPC_MEM_OP0 = 4, 5
NPC_MEM_DST_ADDR, NPC_MEM_DST = 8, 9
NPC_MEM_OP1_ADDR, NPC_MEM_OP1 = 12, 13
NPC_UNUSED_ADDR, NPC_UNUSED_VAL = 14, 15
NPC_PEDERSEN_IN0_ADDR, NPC_PEDERSEN_IN0_VAL = 6, 7           # step 512
NPC_PEDERSEN_OUT_ADDR, NPC_PEDERSEN_OUT_VAL = 134, 135       # step 512
NPC_PEDERSEN_IN1_ADDR, NPC_PEDERSEN_IN1_VAL = 262, 263       # step 512
NPC_RC128_ADDR, NPC_RC128_VAL = 70, 71                       # step 256
NPC_ECDSA_PUBKEY_ADDR, NPC_ECDSA_PUBKEY_VAL = 390, 391       # step 32768
NPC_ECDSA_MESSAGE_ADDR, NPC_ECDSA_MESSAGE_VAL = 16774, 16775  # step 32768
NPC_BITWISE_POOL_ADDR, NPC_BITWISE_POOL_VAL = 198, 199       # step 256
NPC_BITWISE_XORY_ADDR, NPC_BITWISE_XORY_VAL = 902, 903       # step 1024
NPC_EC_OP_PX_ADDR, NPC_EC_OP_PX_VAL = 8582, 8583             # step 16384
NPC_EC_OP_PY_ADDR, NPC_EC_OP_PY_VAL = 4486, 4487
NPC_EC_OP_QX_ADDR, NPC_EC_OP_QX_VAL = 12678, 12679
NPC_EC_OP_QY_ADDR, NPC_EC_OP_QY_VAL = 2438, 2439
NPC_EC_OP_M_ADDR, NPC_EC_OP_M_VAL = 10630, 10631
NPC_EC_OP_RX_ADDR, NPC_EC_OP_RX_VAL = 6534, 6535
NPC_EC_OP_RY_ADDR, NPC_EC_OP_RY_VAL = 14726, 14727
NPC_POSEIDON_IN0_ADDR, NPC_POSEIDON_IN0_VAL = 38, 39         # step 512
NPC_POSEIDON_IN1_ADDR, NPC_POSEIDON_IN1_VAL = 102, 103
NPC_POSEIDON_IN2_ADDR, NPC_POSEIDON_IN2_VAL = 166, 167
NPC_POSEIDON_OUT0_ADDR, NPC_POSEIDON_OUT0_VAL = 230, 231
NPC_POSEIDON_OUT1_ADDR, NPC_POSEIDON_OUT1_VAL = 294, 295
NPC_POSEIDON_OUT2_ADDR, NPC_POSEIDON_OUT2_VAL = 358, 359

_NPC_STEPS = {}
for _cells, _step in [
    ((NPC_PUBMEM_ADDR, NPC_PUBMEM_VAL), PUBLIC_MEMORY_STEP),
    ((NPC_PEDERSEN_IN0_ADDR, NPC_PEDERSEN_IN0_VAL, NPC_PEDERSEN_OUT_ADDR,
      NPC_PEDERSEN_OUT_VAL, NPC_PEDERSEN_IN1_ADDR, NPC_PEDERSEN_IN1_VAL),
     CYCLE_HEIGHT * PEDERSEN_BUILTIN_RATIO),
    ((NPC_RC128_ADDR, NPC_RC128_VAL),
     CYCLE_HEIGHT * RANGE_CHECK_BUILTIN_RATIO),
    ((NPC_ECDSA_PUBKEY_ADDR, NPC_ECDSA_PUBKEY_VAL, NPC_ECDSA_MESSAGE_ADDR,
      NPC_ECDSA_MESSAGE_VAL), CYCLE_HEIGHT * ECDSA_BUILTIN_RATIO),
    ((NPC_BITWISE_POOL_ADDR, NPC_BITWISE_POOL_VAL),
     BITWISE_RATIO * CYCLE_HEIGHT // 4),
    ((NPC_BITWISE_XORY_ADDR, NPC_BITWISE_XORY_VAL),
     BITWISE_RATIO * CYCLE_HEIGHT),
    ((NPC_EC_OP_PX_ADDR, NPC_EC_OP_PX_VAL, NPC_EC_OP_PY_ADDR,
      NPC_EC_OP_PY_VAL, NPC_EC_OP_QX_ADDR, NPC_EC_OP_QX_VAL,
      NPC_EC_OP_QY_ADDR, NPC_EC_OP_QY_VAL, NPC_EC_OP_M_ADDR,
      NPC_EC_OP_M_VAL, NPC_EC_OP_RX_ADDR, NPC_EC_OP_RX_VAL,
      NPC_EC_OP_RY_ADDR, NPC_EC_OP_RY_VAL),
     EC_OP_BUILTIN_RATIO * CYCLE_HEIGHT),
    ((NPC_POSEIDON_IN0_ADDR, NPC_POSEIDON_IN0_VAL, NPC_POSEIDON_IN1_ADDR,
      NPC_POSEIDON_IN1_VAL, NPC_POSEIDON_IN2_ADDR, NPC_POSEIDON_IN2_VAL,
      NPC_POSEIDON_OUT0_ADDR, NPC_POSEIDON_OUT0_VAL, NPC_POSEIDON_OUT1_ADDR,
      NPC_POSEIDON_OUT1_VAL, NPC_POSEIDON_OUT2_ADDR, NPC_POSEIDON_OUT2_VAL),
     POSEIDON_RATIO * CYCLE_HEIGHT),
]:
    for _c in _cells:
        _NPC_STEPS[_c] = _step

# RangeCheck column (col 7) cells
RC_OFF_DST, RC_ORDERED, RC_OFF_OP1, RC_OFF_OP0, RC_UNUSED = 0, 2, 4, 8, 12
RC16_COMPONENT = 12          # step 32 (16 * 16 / 8)
DIL_UNORDERED, DIL_ORDERED = 1, 5    # step 8
POS_PARTIAL0, POS_PARTIAL0_SQ = 3, 7  # step 8

# Auxiliary column (col 8) cells — even, step 16
AUX_AP, AUX_TMP0, AUX_OP0_MUL_OP1, AUX_FP, AUX_TMP1, AUX_RES = 0, 2, 4, 8, 10, 12

# Pedersen
PED_BIT251_196_192 = 71      # col8, step 256
PED_BIT251_196 = 255         # col4, step 256

# Bitwise (col 7)
BITWISE_RES_SHIFTED = (9, 521, 265, 777)   # offsets 0..3, step 1024

# ECDSA (col 8)
E_PUBKEY_DOUBLING_X, E_PUBKEY_DOUBLING_Y, E_PUBKEY_DOUBLING_SLOPE = 1, 33, 35
E_PUBKEY_SUM_X, E_PUBKEY_SUM_Y = 17, 49
E_PUBKEY_SUM_XDIFF_INV, E_PUBKEY_SUM_SLOPE = 51, 19
E_R_SUFFIX = 9                               # step 64
E_MESSAGE_SUFFIX = 59                        # step 128
E_GEN_SUM_X, E_GEN_SUM_Y = 27, 91            # step 128
E_GEN_SUM_XDIFF_INV, E_GEN_SUM_SLOPE = 7, 123
E_R_POINT_SLOPE, E_R_POINT_XDIFF_INV = 16331, 32715   # step 32768
E_R_INV, E_W_INV = 16355, 32739
E_MESSAGE_INV, E_PUBKEY_X_SQUARED = 16363, 32747
E_B_SLOPE, E_B_XDIFF_INV = 32763, 32647

# EcOp (col 8, step 64)
O_Q_DOUBLING_X, O_Q_DOUBLING_Y, O_Q_DOUBLING_SLOPE = 41, 25, 57
O_R_SUM_X, O_R_SUM_Y, O_R_SUM_SLOPE, O_R_SUM_XDIFF_INV = 5, 37, 11, 43
O_M_SUFFIX = 21
O_M_BIT251_196_192, O_M_BIT251_196 = 16371, 16339     # step 16384

# Poseidon (col 8)
POS_FULL0, POS_FULL0_SQ = 53, 29             # step 64
POS_FULL1, POS_FULL1_SQ = 13, 61
POS_FULL2, POS_FULL2_SQ = 45, 3
POS_PARTIAL1, POS_PARTIAL1_SQ = 6, 14        # step 16

# ext column (col 9)
PERM_MEM_CELL, PERM_RC_CELL = 0, 1           # steps 2, 4
DIL_AGG_CELL, PERM_DIL_CELL = 3, 7           # step 8

# periodic registry indices
(P_PEDERSEN_X, P_PEDERSEN_Y, P_ECDSA_GEN_X, P_ECDSA_GEN_Y,
 P_POS_FULL_KEY0, P_POS_FULL_KEY1, P_POS_FULL_KEY2,
 P_POS_PARTIAL_KEY0, P_POS_PARTIAL_KEY1) = range(9)

PEDERSEN_STEP_ROWS = PEDERSEN_BUILTIN_RATIO * CYCLE_HEIGHT  # 512
RC128_STEP_ROWS = RANGE_CHECK_BUILTIN_RATIO * CYCLE_HEIGHT  # 256
BITWISE_STEP_ROWS = BITWISE_RATIO * CYCLE_HEIGHT            # 1024
ECDSA_STEP_ROWS = ECDSA_BUILTIN_RATIO * CYCLE_HEIGHT        # 32768
EC_OP_STEP_ROWS = EC_OP_BUILTIN_RATIO * CYCLE_HEIGHT        # 16384
POSEIDON_STEP_ROWS = POSEIDON_RATIO * CYCLE_HEIGHT          # 512

# StarkWare's public margin round-key constants for the optimized Poseidon
# variant (hardcoded in the reference AIR, starknet/air.rs:2040-2185, and
# in StarkWare's deployed Solidity verifier)
MARGIN_FULL_TO_PARTIAL1_KEY = 2006642341318481906727563724340978325665491359415674592697055778067937914672
MARGIN_FULL_TO_PARTIAL2_KEY = 427751140904099001132521606468025610873158555767197326325930641757709538586
MARGIN_PARTIAL_TO_FULL0_KEY = 560279373700919169769089400651532183647886248799764942664266404650165812023
MARGIN_PARTIAL_TO_FULL1_KEY = 1401754474293352309994371631695783042590401941592571735921592823982231996415
MARGIN_PARTIAL_TO_FULL2_KEY = 1246177936547655338400308396717835700699368047388302793172818304164989556526


def flag(bit, cycle_offset=0):
    off = CYCLE_HEIGHT * cycle_offset + bit
    return Trace(0, off) - 2 * Trace(0, off + 1)


def npc(cell, offset=0):
    step = _NPC_STEPS.get(cell, CYCLE_HEIGHT)
    return Trace(5, step * offset + cell)


def mem(cell, offset=0):
    return Trace(6, MEMORY_STEP * offset + cell)


def rc(cell, offset=0):
    step = RANGE_CHECK_STEP if cell == RC_ORDERED else CYCLE_HEIGHT
    return Trace(7, step * offset + cell)


def rc16_component(offset=0):
    return Trace(7, 32 * offset + RC16_COMPONENT)


def diluted_unordered(offset=0):
    return Trace(7, DILUTED_CHECK_STEP * offset + DIL_UNORDERED)


def diluted_ordered(offset=0):
    return Trace(7, DILUTED_CHECK_STEP * offset + DIL_ORDERED)


def pos_partial0(offset=0, sq=False):
    return Trace(7, 8 * offset + (POS_PARTIAL0_SQ if sq else POS_PARTIAL0))


def bitwise_chunk(chunk, spacing_offset, offset=0):
    return Trace(7, 256 * offset + 1 + 64 * chunk + 16 * spacing_offset)


def bitwise_res_shifted(spacing_offset, offset=0):
    return Trace(7, 1024 * offset + BITWISE_RES_SHIFTED[spacing_offset])


def aux(cell, offset=0):
    return Trace(8, CYCLE_HEIGHT * offset + cell)


def ped_psum_x(offset=0):
    return Trace(1, offset)


def ped_psum_y(offset=0):
    return Trace(2, offset)


def ped_suffix(offset=0):
    return Trace(3, offset)


def ped_slope(offset=0):
    return Trace(4, offset)


def ped_bit251_196(offset=0):
    return Trace(4, (PEDERSEN_STEP_ROWS // 2) * offset + PED_BIT251_196)


def ped_bit251_196_192(offset=0):
    return Trace(8, (PEDERSEN_STEP_ROWS // 2) * offset + PED_BIT251_196_192)


def ecdsa(cell, offset=0):
    if cell in (E_MESSAGE_SUFFIX, E_GEN_SUM_X, E_GEN_SUM_Y,
                E_GEN_SUM_XDIFF_INV, E_GEN_SUM_SLOPE):
        step = ECDSA_STEP_ROWS // EC_OP_SCALAR_HEIGHT      # 128
    elif cell in (E_R_POINT_SLOPE, E_R_POINT_XDIFF_INV, E_R_INV, E_W_INV,
                  E_MESSAGE_INV, E_PUBKEY_X_SQUARED, E_B_SLOPE,
                  E_B_XDIFF_INV):
        step = ECDSA_STEP_ROWS
    else:
        step = EC_OP_STEP_ROWS // EC_OP_SCALAR_HEIGHT      # 64
    return Trace(8, step * offset + cell)


def ec_op(cell, offset=0):
    if cell in (O_M_BIT251_196_192, O_M_BIT251_196):
        step = EC_OP_STEP_ROWS
    else:
        step = EC_OP_STEP_ROWS // EC_OP_SCALAR_HEIGHT      # 64
    return Trace(8, step * offset + cell)


def pos_full(state, offset=0, sq=False):
    cell = [(POS_FULL0, POS_FULL0_SQ), (POS_FULL1, POS_FULL1_SQ),
            (POS_FULL2, POS_FULL2_SQ)][state][1 if sq else 0]
    return Trace(8, 64 * offset + cell)


def pos_partial1(offset=0, sq=False):
    return Trace(8, 16 * offset + (POS_PARTIAL1_SQ if sq else POS_PARTIAL1))


def perm_mem(offset=0):
    return Trace(9, MEMORY_STEP * offset + PERM_MEM_CELL)


def perm_rc(offset=0):
    return Trace(9, RANGE_CHECK_STEP * offset + PERM_RC_CELL)


def perm_diluted(offset=0):
    return Trace(9, DILUTED_CHECK_STEP * offset + PERM_DIL_CELL)


def diluted_aggregate(offset=0):
    return Trace(9, DILUTED_CHECK_STEP * offset + DIL_AGG_CELL)


@functools.lru_cache(maxsize=1)
def _periodic_columns():
    """The 9 periodic columns (starknet/air.rs:47-104), derived at runtime
    from the public pedersen/generator points and poseidon round keys
    (table layouts per builtins/src/{pedersen,ecdsa,poseidon}/periodic.rs)."""
    from ...field import Fp252
    p = Fp252.MODULUS

    ped_pts = (pedersen_builtin.periodic_table_points(0)
               + pedersen_builtin.periodic_table_points(1))
    r512 = Fp252.root_of_unity_int(512)
    ped_x = PeriodicColumn.from_table([pt[0] for pt in ped_pts],
                                      PEDERSEN_STEP_ROWS, p, r512)
    ped_y = PeriodicColumn.from_table([pt[1] for pt in ped_pts],
                                      PEDERSEN_STEP_ROWS, p, r512)

    # the generator exponentiation caps at 250 doublings
    # (gen_ec_mad_steps max_point_doublings=250), so the table holds
    # G*2^0..G*2^250 then 5 copies of G*2^250 — verified against the
    # deployed verifier's GENERATOR_POINTS_{X,Y}_COEFFS
    gen_chain = curve_mod.doublings(curve_mod.GENERATOR, 251)
    gen_pts = gen_chain + [gen_chain[-1]] * (256 - len(gen_chain))
    r256 = Fp252.root_of_unity_int(256)
    gen_x = PeriodicColumn.from_table([pt[0] for pt in gen_pts],
                                      ECDSA_STEP_ROWS, p, r256)
    gen_y = PeriodicColumn.from_table([pt[1] for pt in gen_pts],
                                      ECDSA_STEP_ROWS, p, r256)

    d = poseidon_builtin.params()
    keys_1st = d["FULL_ROUND_KEYS_1ST_HALF"]
    keys_2nd = d["FULL_ROUND_KEYS_2ND_HALF"]
    r8 = Fp252.root_of_unity_int(8)
    full_keys = []
    for j in range(3):
        table = [keys_1st[1][j], keys_1st[2][j], keys_1st[3][j], 0,
                 keys_2nd[1][j], keys_2nd[2][j], keys_2nd[3][j], 0]
        full_keys.append(PeriodicColumn.from_table(
            table, POSEIDON_STEP_ROWS, p, r8))

    # the partial-round constraint folds the MDS action of the two prior
    # rounds, so the periodic key is the matching combination of three
    # consecutive optimized keys: k[j] = OPT[j+3] - 2 OPT[j+2] - 4 OPT[j+1]
    # (verified against StarkWare's deployed verifier coefficients)
    opt = poseidon_builtin.optimized_partial_round_keys()
    table0 = [(opt[k + 3] - 2 * opt[k + 2] - 4 * opt[k + 1]) % p
              for k in range(61)] + [0] * 3
    table1 = [(opt[64 + k] - 2 * opt[63 + k] - 4 * opt[62 + k]) % p
              for k in range(19)] + [0] * 13
    r64 = Fp252.root_of_unity_int(64)
    r32 = Fp252.root_of_unity_int(32)
    partial0 = PeriodicColumn.from_table(table0, POSEIDON_STEP_ROWS, p, r64)
    partial1 = PeriodicColumn.from_table(table1, POSEIDON_STEP_ROWS, p, r32)

    return [ped_x, ped_y, gen_x, gen_y] + full_keys + [partial0, partial1]


class StarknetAirConfig:
    """Starknet-layout AirConfig (starknet/air.rs:106-2477)."""

    NUM_BASE_COLUMNS = 9
    NUM_EXTENSION_COLUMNS = 1
    NUM_CHALLENGES = NUM_CHALLENGES
    NUM_HINTS = NUM_HINTS
    CE_BLOWUP_FACTOR = 2
    CYCLE_HEIGHT = CYCLE_HEIGHT
    PUBLIC_MEMORY_STEP = PUBLIC_MEMORY_STEP

    @staticmethod
    def periodic_columns(trace_len: int):
        return [pc.bind(trace_len) for pc in _periodic_columns()]

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
        assert n % ECDSA_STEP_ROWS == 0, \
            "starknet layout requires trace_len % 32768 == 0"

        one = Constant(1)
        two = Constant(2)
        four = Constant(4)
        offset_size = Constant(1 << 16)
        half_offset_size = Constant(1 << 15)

        z_mem, a_mem, z_rc = Challenge(MEMORY_Z), Challenge(MEMORY_A), \
            Challenge(RC_Z)
        z_dp = Challenge(DILUTED_PERM_Z)
        z_da, a_da = Challenge(DILUTED_AGG_Z), Challenge(DILUTED_AGG_A)

        # -- shared composite expressions -----------------------------------
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

        rc_value = rc16_component(0)
        for k in range(1, RANGE_CHECK_BUILTIN_PARTS):
            rc_value = rc_value * offset_size + rc16_component(k)

        ecdsa_key_x_sq = ecdsa(E_PUBKEY_DOUBLING_X) * ecdsa(E_PUBKEY_DOUBLING_X)
        ecdsa_gen_b0 = ecdsa(E_MESSAGE_SUFFIX) \
            - (ecdsa(E_MESSAGE_SUFFIX, 1) + ecdsa(E_MESSAGE_SUFFIX, 1))
        ecdsa_gen_b0_neg = one - ecdsa_gen_b0
        ecdsa_key_b0 = ecdsa(E_R_SUFFIX) \
            - (ecdsa(E_R_SUFFIX, 1) + ecdsa(E_R_SUFFIX, 1))
        ecdsa_key_b0_neg = one - ecdsa_key_b0

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

        ec_op_qx_sq = ec_op(O_Q_DOUBLING_X) * ec_op(O_Q_DOUBLING_X)
        ec_op_bit = ec_op(O_M_SUFFIX) \
            - (ec_op(O_M_SUFFIX, 1) + ec_op(O_M_SUFFIX, 1))
        ec_op_bit_neg = one - ec_op_bit

        def full_cubed(state, k):
            return pos_full(state, k) * pos_full(state, k, sq=True)

        def partial0_cubed(k):
            return pos_partial0(k) * pos_partial0(k, sq=True)

        def partial1_cubed(k):
            return pos_partial1(k) * pos_partial1(k, sq=True)

        # -- zerofiers --------------------------------------------------------
        flag0_zerofier = X.pow(n // CYCLE_HEIGHT) \
            - Constant(pow(g, F_ZERO * n // CYCLE_HEIGHT, pb))
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

        every_eighth_row_zerofier_inv = one / (X.pow(n // 8) - one)
        eighth_last_row_zerofier = X - Constant(pow(g, 8 * (n // 8 - 1), pb))
        eighth_last_row_zerofier_inv = one / eighth_last_row_zerofier
        every_8_rows_except_last_zerofier_inv = \
            eighth_last_row_zerofier * every_eighth_row_zerofier_inv

        every_64_row_zerofier_inv = one / (X.pow(n // 64) - one)
        every_256_row_zerofier_inv = one / (X.pow(n // 256) - one)

        # pedersen (groups of 256 rows, step 1)
        pedersen_transition_zerofier_inv = \
            (X.pow(n // 256) - Constant(pow(g, 255 * n // 256, pb))) \
            / every_row_zerofier
        pedersen_zero_suffix_zerofier_inv = \
            one / (X.pow(n // 256) - Constant(pow(g, 63 * n // 64, pb)))
        pedersen_zeros_tail_zerofier_inv = \
            one / (X.pow(n // 256) - Constant(pow(g, 255 * n // 256, pb)))
        pedersen_copy_zerofier_inv = \
            (X.pow(n // 512) - Constant(pow(g, n // 2, pb))) \
            * every_256_row_zerofier_inv
        every_512_row_zerofier_inv = one / (X.pow(n // 512) - one)
        every_512_rows_except_last_zerofier = \
            (X - Constant(pow(g, 512 * (n // 512 - 1), pb))) \
            * every_512_row_zerofier_inv

        # rc128 (256 rows per instance)
        every_256_rows_except_last_zerofier = \
            (X - Constant(pow(g, 256 * (n // 256 - 1), pb))) \
            * every_256_row_zerofier_inv

        # ecdsa / ec_op
        ec_op_transition_zerofier_inv = \
            (X.pow(n // 16384) - Constant(pow(g, 255 * n // 256, pb))) \
            * every_64_row_zerofier_inv
        every_128_row_zerofier = X.pow(n // 128) - one
        ecdsa_transition_zerofier_inv = \
            (X.pow(n // 32768) - Constant(pow(g, 255 * n // 256, pb))) \
            / every_128_row_zerofier
        ecdsa_zero_suffix_zerofier_inv = \
            one / (X.pow(n // 32768) - Constant(pow(g, 251 * n // 256, pb)))
        ecdsa_zeros_tail_zerofier_inv = \
            one / (X.pow(n // 32768) - Constant(pow(g, 255 * n // 256, pb)))
        ec_op_zero_suffix_zerofier_inv = \
            one / (X.pow(n // 16384) - Constant(pow(g, 251 * n // 256, pb)))
        ec_op_zeros_tail_zerofier_inv = \
            one / (X.pow(n // 16384) - Constant(pow(g, 255 * n // 256, pb)))
        all_ecdsa_zerofier_inv = one / (X.pow(n // 32768) - one)
        all_ec_op_zerofier_inv = one / (X.pow(n // 16384) - one)
        all_ecdsa_except_last_zerofier_inv = \
            (X - Constant(pow(g, 32768 * (n // 32768 - 1), pb))) \
            * all_ecdsa_zerofier_inv
        all_ec_op_except_last_zerofier_inv = \
            (X - Constant(pow(g, 16384 * (n // 16384 - 1), pb))) \
            * all_ec_op_zerofier_inv

        # bitwise (1024 rows per instance, pool step 256)
        bitwise_transition_zerofier_inv = \
            (X.pow(n // 1024) - Constant(pow(g, 3 * n // 4, pb))) \
            * every_256_row_zerofier_inv
        all_bitwise_zerofier = X.pow(n // 1024) - one
        all_bitwise_zerofier_inv = one / all_bitwise_zerofier
        all_bitwise_except_last_zerofier_inv = \
            (X - Constant(pow(g, 1024 * (n // 1024 - 1), pb))) \
            * all_bitwise_zerofier_inv
        seg = all_bitwise_zerofier
        for k in range(1, 16):
            seg = seg * (X.pow(n // 1024) - Constant(pow(g, k * n // 64, pb)))
        every_16_bit_segment_zerofier_inv = one / seg

        # poseidon domains (starknet/air.rs:1856-2121)
        def dom_pow512(num, den):
            return X.pow(n // 512) - Constant(pow(g, num * n // den, pb))

        domain14 = dom_pow512(3, 4) * dom_pow512(7, 8)
        domain15 = dom_pow512(5, 8) * domain14
        domain16 = dom_pow512(31, 32)
        domain17 = (dom_pow512(11, 16) * dom_pow512(23, 32)
                    * dom_pow512(25, 32) * dom_pow512(13, 16)
                    * dom_pow512(27, 32) * dom_pow512(29, 32)
                    * dom_pow512(15, 16) * domain16)
        domain19 = dom_pow512(61, 64) * dom_pow512(63, 64) * domain16
        domain20 = dom_pow512(19, 32) * dom_pow512(21, 32) * domain15 * domain17
        poseidon_io_step_zerofier_inv = domain15 * every_64_row_zerofier_inv
        all_poseidon_zerofier_inv = every_512_row_zerofier_inv
        all_poseidon_except_last_zerofier_inv = \
            (X - Constant(pow(g, 512 * (n // 512 - 1), pb))) \
            * every_512_row_zerofier_inv
        poseidon_half_full_transition_zerofier_inv = \
            (X.pow(n // 256) - Constant(pow(g, 3 * n // 4, pb))) \
            * every_64_row_zerofier_inv

        pedersen_point_x = Periodic(P_PEDERSEN_X)
        pedersen_point_y = Periodic(P_PEDERSEN_Y)
        gen_point_x = Periodic(P_ECDSA_GEN_X)
        gen_point_y = Periodic(P_ECDSA_GEN_Y)
        pos_full_key = [Periodic(P_POS_FULL_KEY0), Periodic(P_POS_FULL_KEY1),
                        Periodic(P_POS_FULL_KEY2)]
        pos_partial_key0 = Periodic(P_POS_PARTIAL_KEY0)
        pos_partial_key1 = Periodic(P_POS_PARTIAL_KEY1)

        shift_point = pedersen_builtin.shift_and_table_points()[0]
        curve_alpha = Constant(curve_mod.ALPHA)
        curve_beta = Constant(curve_mod.BETA)
        shift_x = Constant(shift_point[0])
        shift_y = Constant(shift_point[1])

        d0 = poseidon_builtin.params()["PARTIAL_ROUND_KEYS"][0]

        c = []

        # ===== cpu (27) =====================================================
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

        # ===== boundary (6) ==================================================
        c.append((aux(AUX_AP) - Hint(H_INITIAL_AP)) * first_row_zerofier_inv)
        c.append((aux(AUX_FP) - Hint(H_INITIAL_AP)) * first_row_zerofier_inv)
        c.append((npc(NPC_PC) - Hint(H_INITIAL_PC)) * first_row_zerofier_inv)
        c.append((aux(AUX_AP) - Hint(H_FINAL_AP)) * last_cycle_zerofier_inv)
        c.append((aux(AUX_FP) - Hint(H_INITIAL_AP)) * last_cycle_zerofier_inv)
        c.append((npc(NPC_PC) - Hint(H_FINAL_PC)) * last_cycle_zerofier_inv)

        # ===== memory (8) ====================================================
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
        c.append(npc(NPC_PUBMEM_ADDR) * every_eighth_row_zerofier_inv)
        c.append(npc(NPC_PUBMEM_VAL) * every_eighth_row_zerofier_inv)

        # ===== rc16 (6) ======================================================
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

        # ===== diluted (7) — step 8 ==========================================
        c.append(((z_dp - diluted_ordered(0)) * perm_diluted(0)
                  + diluted_unordered(0) - z_dp) * first_row_zerofier_inv)
        c.append(((z_dp - diluted_ordered(1)) * perm_diluted(1)
                  - (z_dp - diluted_unordered(1)) * perm_diluted(0))
                 * every_8_rows_except_last_zerofier_inv)
        c.append((perm_diluted(0) - Hint(H_DILUTED_PRODUCT))
                 * eighth_last_row_zerofier_inv)
        c.append((diluted_aggregate(0) - one) * first_row_zerofier_inv)
        c.append((diluted_ordered(0) - Hint(H_DILUTED_FIRST))
                 * first_row_zerofier_inv)
        diluted_diff = diluted_ordered(1) - diluted_ordered(0)
        c.append((diluted_aggregate(1)
                  - (diluted_aggregate(0) * (one + z_da * diluted_diff)
                     + a_da * diluted_diff * diluted_diff))
                 * every_8_rows_except_last_zerofier_inv)
        c.append((diluted_aggregate(0) - Hint(H_DILUTED_CUMULATIVE))
                 * eighth_last_row_zerofier_inv)

        # ===== pedersen (25) — 256-row groups, step 1 =========================
        c.append((ped_bit251_196_192(0)
                  * (ped_suffix(0) - (ped_suffix(1) + ped_suffix(1))))
                 * every_256_row_zerofier_inv)
        c.append((ped_bit251_196_192(0)
                  * (ped_suffix(1) - ped_suffix(192) * Constant(1 << 191)))
                 * every_256_row_zerofier_inv)
        c.append((ped_bit251_196_192(0)
                  - ped_bit251_196(0)
                  * (ped_suffix(192) - (ped_suffix(193) + ped_suffix(193))))
                 * every_256_row_zerofier_inv)
        c.append((ped_bit251_196(0)
                  * (ped_suffix(193) - ped_suffix(196) * Constant(8)))
                 * every_256_row_zerofier_inv)
        c.append((ped_bit251_196(0)
                  - (ped_suffix(251) - (ped_suffix(252) + ped_suffix(252)))
                  * (ped_suffix(196) - (ped_suffix(197) + ped_suffix(197))))
                 * every_256_row_zerofier_inv)
        c.append(((ped_suffix(251) - (ped_suffix(252) + ped_suffix(252)))
                  * (ped_suffix(197) - ped_suffix(251) * Constant(1 << 54)))
                 * every_256_row_zerofier_inv)
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
        c.append((ped_psum_x(0) - shift_x) * every_512_row_zerofier_inv)
        c.append((ped_psum_y(0) - shift_y) * every_512_row_zerofier_inv)
        c.append((npc(NPC_PEDERSEN_IN0_VAL) - ped_suffix(0))
                 * every_512_row_zerofier_inv)
        c.append((npc(NPC_PEDERSEN_IN0_ADDR, 1)
                  - (npc(NPC_PEDERSEN_OUT_ADDR) + one))
                 * every_512_rows_except_last_zerofier)
        c.append((npc(NPC_PEDERSEN_IN0_ADDR) - Hint(H_INITIAL_PEDERSEN_ADDR))
                 * first_row_zerofier_inv)
        c.append((npc(NPC_PEDERSEN_IN1_VAL) - ped_suffix(256))
                 * every_512_row_zerofier_inv)
        c.append((npc(NPC_PEDERSEN_IN1_ADDR)
                  - (npc(NPC_PEDERSEN_IN0_ADDR) + one))
                 * every_512_row_zerofier_inv)
        c.append((npc(NPC_PEDERSEN_OUT_VAL) - ped_psum_x(511))
                 * every_512_row_zerofier_inv)
        c.append((npc(NPC_PEDERSEN_OUT_ADDR)
                  - (npc(NPC_PEDERSEN_IN1_ADDR) + one))
                 * every_512_row_zerofier_inv)

        # ===== rc128 (3) =====================================================
        c.append((rc_value - npc(NPC_RC128_VAL)) * every_256_row_zerofier_inv)
        c.append((npc(NPC_RC128_ADDR, 1) - (npc(NPC_RC128_ADDR) + one))
                 * every_256_rows_except_last_zerofier)
        c.append((npc(NPC_RC128_ADDR) - Hint(H_INITIAL_RC_ADDR))
                 * first_row_zerofier_inv)

        # ===== ecdsa (41) ====================================================
        c.append((ecdsa_key_x_sq + ecdsa_key_x_sq + ecdsa_key_x_sq
                  + curve_alpha
                  - (ecdsa(E_PUBKEY_DOUBLING_Y) + ecdsa(E_PUBKEY_DOUBLING_Y))
                  * ecdsa(E_PUBKEY_DOUBLING_SLOPE))
                 * ec_op_transition_zerofier_inv)
        c.append((ecdsa(E_PUBKEY_DOUBLING_SLOPE) * ecdsa(E_PUBKEY_DOUBLING_SLOPE)
                  - (ecdsa(E_PUBKEY_DOUBLING_X) + ecdsa(E_PUBKEY_DOUBLING_X)
                     + ecdsa(E_PUBKEY_DOUBLING_X, 1)))
                 * ec_op_transition_zerofier_inv)
        c.append((ecdsa(E_PUBKEY_DOUBLING_Y) + ecdsa(E_PUBKEY_DOUBLING_Y, 1)
                  - ecdsa(E_PUBKEY_DOUBLING_SLOPE)
                  * (ecdsa(E_PUBKEY_DOUBLING_X) - ecdsa(E_PUBKEY_DOUBLING_X, 1)))
                 * ec_op_transition_zerofier_inv)
        c.append((ecdsa_gen_b0 * (ecdsa_gen_b0 - one))
                 * ecdsa_transition_zerofier_inv)
        c.append(ecdsa(E_MESSAGE_SUFFIX) * ecdsa_zero_suffix_zerofier_inv)
        c.append(ecdsa(E_MESSAGE_SUFFIX) * ecdsa_zeros_tail_zerofier_inv)
        c.append((ecdsa_gen_b0 * (ecdsa(E_GEN_SUM_Y) - gen_point_y)
                  - ecdsa(E_GEN_SUM_SLOPE) * (ecdsa(E_GEN_SUM_X) - gen_point_x))
                 * ecdsa_transition_zerofier_inv)
        c.append((ecdsa(E_GEN_SUM_SLOPE) * ecdsa(E_GEN_SUM_SLOPE)
                  - ecdsa_gen_b0 * (ecdsa(E_GEN_SUM_X) + gen_point_x
                                    + ecdsa(E_GEN_SUM_X, 1)))
                 * ecdsa_transition_zerofier_inv)
        c.append((ecdsa_gen_b0 * (ecdsa(E_GEN_SUM_Y) + ecdsa(E_GEN_SUM_Y, 1))
                  - ecdsa(E_GEN_SUM_SLOPE)
                  * (ecdsa(E_GEN_SUM_X) - ecdsa(E_GEN_SUM_X, 1)))
                 * ecdsa_transition_zerofier_inv)
        c.append((ecdsa(E_GEN_SUM_XDIFF_INV)
                  * (ecdsa(E_GEN_SUM_X) - gen_point_x) - one)
                 * ecdsa_transition_zerofier_inv)
        c.append((ecdsa_gen_b0_neg
                  * (ecdsa(E_GEN_SUM_X, 1) - ecdsa(E_GEN_SUM_X)))
                 * ecdsa_transition_zerofier_inv)
        c.append((ecdsa_gen_b0_neg
                  * (ecdsa(E_GEN_SUM_Y, 1) - ecdsa(E_GEN_SUM_Y)))
                 * ecdsa_transition_zerofier_inv)
        c.append((ecdsa_key_b0 * (ecdsa_key_b0 - one))
                 * ec_op_transition_zerofier_inv)
        c.append(ecdsa(E_R_SUFFIX) * ec_op_zero_suffix_zerofier_inv)
        c.append(ecdsa(E_R_SUFFIX) * ec_op_zeros_tail_zerofier_inv)
        c.append((ecdsa_key_b0
                  * (ecdsa(E_PUBKEY_SUM_Y) - ecdsa(E_PUBKEY_DOUBLING_Y))
                  - ecdsa(E_PUBKEY_SUM_SLOPE)
                  * (ecdsa(E_PUBKEY_SUM_X) - ecdsa(E_PUBKEY_DOUBLING_X)))
                 * ec_op_transition_zerofier_inv)
        c.append((ecdsa(E_PUBKEY_SUM_SLOPE) * ecdsa(E_PUBKEY_SUM_SLOPE)
                  - ecdsa_key_b0 * (ecdsa(E_PUBKEY_SUM_X)
                                    + ecdsa(E_PUBKEY_DOUBLING_X)
                                    + ecdsa(E_PUBKEY_SUM_X, 1)))
                 * ec_op_transition_zerofier_inv)
        c.append((ecdsa_key_b0
                  * (ecdsa(E_PUBKEY_SUM_Y) + ecdsa(E_PUBKEY_SUM_Y, 1))
                  - ecdsa(E_PUBKEY_SUM_SLOPE)
                  * (ecdsa(E_PUBKEY_SUM_X) - ecdsa(E_PUBKEY_SUM_X, 1)))
                 * ec_op_transition_zerofier_inv)
        c.append((ecdsa(E_PUBKEY_SUM_XDIFF_INV)
                  * (ecdsa(E_PUBKEY_SUM_X) - ecdsa(E_PUBKEY_DOUBLING_X)) - one)
                 * ec_op_transition_zerofier_inv)
        c.append((ecdsa_key_b0_neg
                  * (ecdsa(E_PUBKEY_SUM_X, 1) - ecdsa(E_PUBKEY_SUM_X)))
                 * ec_op_transition_zerofier_inv)
        c.append((ecdsa_key_b0_neg
                  * (ecdsa(E_PUBKEY_SUM_Y, 1) - ecdsa(E_PUBKEY_SUM_Y)))
                 * ec_op_transition_zerofier_inv)
        c.append((ecdsa(E_GEN_SUM_X) - shift_x) * all_ecdsa_zerofier_inv)
        c.append((ecdsa(E_GEN_SUM_Y) + shift_y) * all_ecdsa_zerofier_inv)
        c.append((ecdsa(E_PUBKEY_SUM_X) - shift_x) * all_ec_op_zerofier_inv)
        c.append((ecdsa(E_PUBKEY_SUM_Y) - shift_y) * all_ec_op_zerofier_inv)
        c.append((ecdsa(E_GEN_SUM_Y, 255)
                  - (ecdsa(E_PUBKEY_SUM_Y, 255)
                     + ecdsa(E_B_SLOPE)
                     * (ecdsa(E_GEN_SUM_X, 255) - ecdsa(E_PUBKEY_SUM_X, 255))))
                 * all_ecdsa_zerofier_inv)
        c.append((ecdsa(E_B_SLOPE) * ecdsa(E_B_SLOPE)
                  - (ecdsa(E_GEN_SUM_X, 255) + ecdsa(E_PUBKEY_SUM_X, 255)
                     + ecdsa(E_PUBKEY_DOUBLING_X, 256)))
                 * all_ecdsa_zerofier_inv)
        c.append((ecdsa(E_GEN_SUM_Y, 255) + ecdsa(E_PUBKEY_DOUBLING_Y, 256)
                  - ecdsa(E_B_SLOPE)
                  * (ecdsa(E_GEN_SUM_X, 255) - ecdsa(E_PUBKEY_DOUBLING_X, 256)))
                 * all_ecdsa_zerofier_inv)
        c.append((ecdsa(E_B_XDIFF_INV)
                  * (ecdsa(E_GEN_SUM_X, 255) - ecdsa(E_PUBKEY_SUM_X, 255)) - one)
                 * all_ecdsa_zerofier_inv)
        c.append((ecdsa(E_PUBKEY_SUM_Y, 256 + 255) + shift_y
                  - ecdsa(E_R_POINT_SLOPE)
                  * (ecdsa(E_PUBKEY_SUM_X, 256 + 255) - shift_x))
                 * all_ecdsa_zerofier_inv)
        c.append((ecdsa(E_R_POINT_SLOPE) * ecdsa(E_R_POINT_SLOPE)
                  - (ecdsa(E_PUBKEY_SUM_X, 256 + 255) + shift_x
                     + ecdsa(E_R_SUFFIX)))
                 * all_ecdsa_zerofier_inv)
        c.append((ecdsa(E_R_POINT_XDIFF_INV)
                  * (ecdsa(E_PUBKEY_SUM_X, 256 + 255) - shift_x) - one)
                 * all_ecdsa_zerofier_inv)
        c.append((ecdsa(E_MESSAGE_SUFFIX) * ecdsa(E_MESSAGE_INV) - one)
                 * all_ecdsa_zerofier_inv)
        c.append((ecdsa(E_R_SUFFIX) * ecdsa(E_PUBKEY_DOUBLING_SLOPE, 255) - one)
                 * all_ec_op_zerofier_inv)
        c.append((ecdsa(E_PUBKEY_X_SQUARED)
                  - ecdsa(E_PUBKEY_DOUBLING_X) * ecdsa(E_PUBKEY_DOUBLING_X))
                 * all_ecdsa_zerofier_inv)
        c.append((ecdsa(E_PUBKEY_DOUBLING_Y) * ecdsa(E_PUBKEY_DOUBLING_Y)
                  - (ecdsa(E_PUBKEY_DOUBLING_X) * ecdsa(E_PUBKEY_X_SQUARED)
                     + ecdsa(E_PUBKEY_DOUBLING_X) * curve_alpha + curve_beta))
                 * all_ecdsa_zerofier_inv)
        c.append((npc(NPC_ECDSA_PUBKEY_ADDR) - Hint(H_INITIAL_ECDSA_ADDR))
                 * first_row_zerofier_inv)
        c.append((npc(NPC_ECDSA_MESSAGE_ADDR)
                  - (npc(NPC_ECDSA_PUBKEY_ADDR) + one))
                 * all_ecdsa_zerofier_inv)
        c.append((npc(NPC_ECDSA_PUBKEY_ADDR, 1)
                  - (npc(NPC_ECDSA_MESSAGE_ADDR) + one))
                 * all_ecdsa_except_last_zerofier_inv)
        c.append((npc(NPC_ECDSA_MESSAGE_VAL) - ecdsa(E_MESSAGE_SUFFIX))
                 * all_ecdsa_zerofier_inv)
        c.append((npc(NPC_ECDSA_PUBKEY_VAL) - ecdsa(E_PUBKEY_DOUBLING_X))
                 * all_ecdsa_zerofier_inv)

        # ===== bitwise (11) ==================================================
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
                 * every_256_row_zerofier_inv)
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

        # ===== ec_op (33) ====================================================
        c.append((npc(NPC_EC_OP_PX_ADDR) - Hint(H_INITIAL_EC_OP_ADDR))
                 * first_row_zerofier_inv)
        c.append((npc(NPC_EC_OP_PX_ADDR, 1)
                  - (npc(NPC_EC_OP_PX_ADDR) + Constant(7)))
                 * all_ec_op_except_last_zerofier_inv)
        c.append((npc(NPC_EC_OP_PY_ADDR) - (npc(NPC_EC_OP_PX_ADDR) + one))
                 * all_ec_op_zerofier_inv)
        c.append((npc(NPC_EC_OP_QX_ADDR) - (npc(NPC_EC_OP_PY_ADDR) + one))
                 * all_ec_op_zerofier_inv)
        c.append((npc(NPC_EC_OP_QY_ADDR) - (npc(NPC_EC_OP_QX_ADDR) + one))
                 * all_ec_op_zerofier_inv)
        c.append((npc(NPC_EC_OP_M_ADDR) - (npc(NPC_EC_OP_QY_ADDR) + one))
                 * all_ec_op_zerofier_inv)
        c.append((npc(NPC_EC_OP_RX_ADDR) - (npc(NPC_EC_OP_M_ADDR) + one))
                 * all_ec_op_zerofier_inv)
        c.append((npc(NPC_EC_OP_RY_ADDR) - (npc(NPC_EC_OP_RX_ADDR) + one))
                 * all_ec_op_zerofier_inv)
        c.append((ec_op_qx_sq + ec_op_qx_sq + ec_op_qx_sq + curve_alpha
                  - (ec_op(O_Q_DOUBLING_Y) + ec_op(O_Q_DOUBLING_Y))
                  * ec_op(O_Q_DOUBLING_SLOPE))
                 * ec_op_transition_zerofier_inv)
        c.append((ec_op(O_Q_DOUBLING_SLOPE) * ec_op(O_Q_DOUBLING_SLOPE)
                  - (ec_op(O_Q_DOUBLING_X) + ec_op(O_Q_DOUBLING_X)
                     + ec_op(O_Q_DOUBLING_X, 1)))
                 * ec_op_transition_zerofier_inv)
        c.append((ec_op(O_Q_DOUBLING_Y) + ec_op(O_Q_DOUBLING_Y, 1)
                  - ec_op(O_Q_DOUBLING_SLOPE)
                  * (ec_op(O_Q_DOUBLING_X) - ec_op(O_Q_DOUBLING_X, 1)))
                 * ec_op_transition_zerofier_inv)
        c.append((npc(NPC_EC_OP_QX_VAL) - ec_op(O_Q_DOUBLING_X))
                 * all_ec_op_zerofier_inv)
        c.append((npc(NPC_EC_OP_QY_VAL) - ec_op(O_Q_DOUBLING_Y))
                 * all_ec_op_zerofier_inv)
        c.append((ec_op(O_M_BIT251_196_192)
                  * (ec_op(O_M_SUFFIX) - (ec_op(O_M_SUFFIX, 1)
                                          + ec_op(O_M_SUFFIX, 1))))
                 * all_ec_op_zerofier_inv)
        c.append((ec_op(O_M_BIT251_196_192)
                  * (ec_op(O_M_SUFFIX, 1)
                     - ec_op(O_M_SUFFIX, 192) * Constant(1 << 191)))
                 * all_ec_op_zerofier_inv)
        c.append((ec_op(O_M_BIT251_196_192)
                  - ec_op(O_M_BIT251_196)
                  * (ec_op(O_M_SUFFIX, 192)
                     - (ec_op(O_M_SUFFIX, 193) + ec_op(O_M_SUFFIX, 193))))
                 * all_ec_op_zerofier_inv)
        c.append((ec_op(O_M_BIT251_196)
                  * (ec_op(O_M_SUFFIX, 193)
                     - ec_op(O_M_SUFFIX, 196) * Constant(8)))
                 * all_ec_op_zerofier_inv)
        c.append((ec_op(O_M_BIT251_196)
                  - (ec_op(O_M_SUFFIX, 251)
                     - (ec_op(O_M_SUFFIX, 252) + ec_op(O_M_SUFFIX, 252)))
                  * (ec_op(O_M_SUFFIX, 196)
                     - (ec_op(O_M_SUFFIX, 197) + ec_op(O_M_SUFFIX, 197))))
                 * all_ec_op_zerofier_inv)
        c.append(((ec_op(O_M_SUFFIX, 251)
                   - (ec_op(O_M_SUFFIX, 252) + ec_op(O_M_SUFFIX, 252)))
                  * (ec_op(O_M_SUFFIX, 197)
                     - ec_op(O_M_SUFFIX, 251) * Constant(1 << 54)))
                 * all_ec_op_zerofier_inv)
        c.append((ec_op_bit * (ec_op_bit - one))
                 * ec_op_transition_zerofier_inv)
        c.append(ec_op(O_M_SUFFIX) * ec_op_zero_suffix_zerofier_inv)
        c.append(ec_op(O_M_SUFFIX) * ec_op_zeros_tail_zerofier_inv)
        c.append((ec_op_bit * (ec_op(O_R_SUM_Y) - ec_op(O_Q_DOUBLING_Y))
                  - ec_op(O_R_SUM_SLOPE)
                  * (ec_op(O_R_SUM_X) - ec_op(O_Q_DOUBLING_X)))
                 * ec_op_transition_zerofier_inv)
        c.append((ec_op(O_R_SUM_SLOPE) * ec_op(O_R_SUM_SLOPE)
                  - ec_op_bit * (ec_op(O_R_SUM_X) + ec_op(O_Q_DOUBLING_X)
                                 + ec_op(O_R_SUM_X, 1)))
                 * ec_op_transition_zerofier_inv)
        c.append((ec_op_bit * (ec_op(O_R_SUM_Y) + ec_op(O_R_SUM_Y, 1))
                  - ec_op(O_R_SUM_SLOPE)
                  * (ec_op(O_R_SUM_X) - ec_op(O_R_SUM_X, 1)))
                 * ec_op_transition_zerofier_inv)
        c.append((ec_op(O_R_SUM_XDIFF_INV)
                  * (ec_op(O_R_SUM_X) - ec_op(O_Q_DOUBLING_X)) - one)
                 * ec_op_transition_zerofier_inv)
        c.append((ec_op_bit_neg * (ec_op(O_R_SUM_X, 1) - ec_op(O_R_SUM_X)))
                 * ec_op_transition_zerofier_inv)
        c.append((ec_op_bit_neg * (ec_op(O_R_SUM_Y, 1) - ec_op(O_R_SUM_Y)))
                 * ec_op_transition_zerofier_inv)
        c.append((ec_op(O_M_SUFFIX) - npc(NPC_EC_OP_M_VAL))
                 * all_ec_op_zerofier_inv)
        c.append((npc(NPC_EC_OP_PX_VAL) - ec_op(O_R_SUM_X))
                 * all_ec_op_zerofier_inv)
        c.append((npc(NPC_EC_OP_PY_VAL) - ec_op(O_R_SUM_Y))
                 * all_ec_op_zerofier_inv)
        c.append((npc(NPC_EC_OP_RX_VAL) - ec_op(O_R_SUM_X, 255))
                 * all_ec_op_zerofier_inv)
        c.append((npc(NPC_EC_OP_RY_VAL) - ec_op(O_R_SUM_Y, 255))
                 * all_ec_op_zerofier_inv)

        # ===== poseidon (28) =================================================
        c.append((npc(NPC_POSEIDON_IN0_ADDR) - Hint(H_INITIAL_POSEIDON_ADDR))
                 * first_row_zerofier_inv)
        c.append((npc(NPC_POSEIDON_IN1_ADDR)
                  - (npc(NPC_POSEIDON_IN0_ADDR) + one))
                 * poseidon_io_step_zerofier_inv)
        c.append((npc(NPC_POSEIDON_IN0_ADDR, 1)
                  - (npc(NPC_POSEIDON_OUT2_ADDR) + one))
                 * all_poseidon_except_last_zerofier_inv)
        for s in range(3):
            c.append((pos_full(s, 0) * pos_full(s, 0) - pos_full(s, 0, sq=True))
                     * every_64_row_zerofier_inv)
        c.append((pos_partial0(0) * pos_partial0(0) - pos_partial0(0, sq=True))
                 * every_eighth_row_zerofier_inv)
        c.append((pos_partial1(0) * pos_partial1(0) - pos_partial1(0, sq=True))
                 * domain14 * domain17 * all_cycles_zerofier_inv)
        keys0 = poseidon_builtin.params()["FULL_ROUND_KEYS_1ST_HALF"][0]
        c.append((npc(NPC_POSEIDON_IN0_VAL) + Constant(keys0[0]) - pos_full(0, 0))
                 * all_poseidon_zerofier_inv)
        c.append((npc(NPC_POSEIDON_IN1_VAL) + Constant(keys0[1]) - pos_full(1, 0))
                 * all_poseidon_zerofier_inv)
        c.append((npc(NPC_POSEIDON_IN2_VAL) + Constant(keys0[2]) - pos_full(2, 0))
                 * all_poseidon_zerofier_inv)
        cub = [full_cubed(s, 0) for s in range(3)]
        c.append((pos_full(0, 1)
                  - (cub[0] + cub[0] + cub[0] + cub[1] + cub[2]
                     + pos_full_key[0]))
                 * poseidon_half_full_transition_zerofier_inv)
        c.append((pos_full(1, 1) + cub[1]
                  - (cub[0] + cub[2] + pos_full_key[1]))
                 * poseidon_half_full_transition_zerofier_inv)
        c.append((pos_full(2, 1) + cub[2] + cub[2]
                  - (cub[0] + cub[1] + pos_full_key[2]))
                 * poseidon_half_full_transition_zerofier_inv)
        cub7 = [full_cubed(s, 7) for s in range(3)]
        c.append((npc(NPC_POSEIDON_OUT0_VAL)
                  - (cub7[0] + cub7[0] + cub7[0] + cub7[1] + cub7[2]))
                 * all_poseidon_zerofier_inv)
        c.append((npc(NPC_POSEIDON_OUT1_VAL) + cub7[1] - (cub7[0] + cub7[2]))
                 * all_poseidon_zerofier_inv)
        c.append((npc(NPC_POSEIDON_OUT2_VAL) + cub7[2] + cub7[2]
                  - (cub7[0] + cub7[1]))
                 * all_poseidon_zerofier_inv)
        for i in range(3):
            c.append((pos_partial0(61 + i) - pos_partial1(i))
                     * all_poseidon_zerofier_inv)
        cub3 = [full_cubed(s, 3) for s in range(3)]
        c.append((pos_partial0(0) + cub3[2] + cub3[2]
                  - (cub3[0] + cub3[1] + Constant(d0[2])))
                 * all_poseidon_zerofier_inv)
        pcub = [partial0_cubed(k) for k in range(3)]
        c.append((pos_partial0(1)
                  - (cub3[1] * Constant(p - 4)
                     + cub3[2] * Constant(10)
                     + pos_partial0(0) * Constant(4)
                     + pcub[0] * Constant(p - 2)
                     + Constant(MARGIN_FULL_TO_PARTIAL1_KEY)))
                 * all_poseidon_zerofier_inv)
        c.append((pos_partial0(2)
                  - (cub3[2] * Constant(8)
                     + pos_partial0(0) * Constant(4)
                     + pcub[0] * Constant(6)
                     + pos_partial0(1) + pos_partial0(1)
                     + pcub[1] * Constant(p - 2)
                     + Constant(MARGIN_FULL_TO_PARTIAL2_KEY)))
                 * all_poseidon_zerofier_inv)
        c.append((pos_partial0(3)
                  - (pcub[0] * Constant(8)
                     + pos_partial0(1) * Constant(4)
                     + pcub[1] * Constant(6)
                     + pos_partial0(2) + pos_partial0(2)
                     + pcub[2] * Constant(p - 2)
                     + pos_partial_key0))
                 * domain19 * every_eighth_row_zerofier_inv)
        p1cub = [partial1_cubed(k) for k in range(3)]
        c.append((pos_partial1(3)
                  - (p1cub[0] * Constant(8)
                     + pos_partial1(1) * Constant(4)
                     + p1cub[1] * Constant(6)
                     + pos_partial1(2) + pos_partial1(2)
                     + p1cub[2] * Constant(p - 2)
                     + pos_partial_key1))
                 * domain20 * all_cycles_zerofier_inv)
        p1cub19 = partial1_cubed(19)
        p1cub20 = partial1_cubed(20)
        p1cub21 = partial1_cubed(21)
        c.append((pos_full(0, 4)
                  - (p1cub19 * Constant(16)
                     + pos_partial1(20) * Constant(8)
                     + p1cub20 * Constant(16)
                     + pos_partial1(21) * Constant(6)
                     + p1cub21
                     + Constant(MARGIN_PARTIAL_TO_FULL0_KEY)))
                 * all_poseidon_zerofier_inv)
        c.append((pos_full(1, 4)
                  - (p1cub20 * Constant(4)
                     + pos_partial1(21) + pos_partial1(21)
                     + p1cub21
                     + Constant(MARGIN_PARTIAL_TO_FULL1_KEY)))
                 * all_poseidon_zerofier_inv)
        c.append((pos_full(2, 4)
                  - (p1cub19 * Constant(8)
                     + pos_partial1(20) * Constant(4)
                     + p1cub20 * Constant(6)
                     + pos_partial1(21) + pos_partial1(21)
                     + p1cub21 * Constant(p - 2)
                     + Constant(MARGIN_PARTIAL_TO_FULL2_KEY)))
                 * all_poseidon_zerofier_inv)

        assert len(c) == 195, len(c)
        return c

    @staticmethod
    def gen_hints(trace_len: int, public_input, challenges, field_modulus: int):
        """Verifier-computable hints (starknet/air.rs:2408-2476)."""
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
        hints[H_INITIAL_ECDSA_ADDR] = segments["ecdsa"].begin_addr
        hints[H_INITIAL_BITWISE_ADDR] = segments["bitwise"].begin_addr
        hints[H_INITIAL_EC_OP_ADDR] = segments["ec_op"].begin_addr
        hints[H_INITIAL_POSEIDON_ADDR] = segments["poseidon"].begin_addr
        return hints
