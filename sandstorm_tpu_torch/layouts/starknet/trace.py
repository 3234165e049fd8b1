"""Execution trace of the starknet layout (port of
sandstorm_tpu/layouts/starknet/trace.py).

The trace is built on the host with numpy, exactly as the JAX package
builds it, which follows the reference sandstorm's
layouts/src/starknet/trace.rs: pedersen traces fill their own step-1
columns (cols 1-4); rc128 parts at col7 cell 12 step 32 with leftover rc
padding in odd-cycle Unused cells (cell 28 mod 32); ECDSA rq/wb/zg step
families scattered into col8 at 64/128-row strides with the per-instance
specials overwriting repurposed step-255 cells; the EC-op loop runs AFTER
ECDSA and overwrites the m-bit flags into ECDSA's unconstrained step-255
cells; poseidon full/partial round states in col8/col7; diluted pool
values at col7 cells 1 mod 8 (ordered at 5 mod 8).

Write-order constraints the reference relies on (and this keeps): ECDSA
specials after its step loops; EC-op after ECDSA; bit flags after pedersen
slopes.  The columns are uploaded to the trace's device in one copy; the
one extension column is built there (running products with one batch
inversion each, and the diluted aggregate as a prefix scan over the
composition of affine maps).
"""

import numpy as np
import torch

from . import (CYCLE_HEIGHT, PUBLIC_MEMORY_STEP, MEMORY_STEP,
               RANGE_CHECK_STEP, DILUTED_CHECK_STEP, PEDERSEN_BUILTIN_RATIO,
               RANGE_CHECK_BUILTIN_RATIO, RANGE_CHECK_BUILTIN_PARTS,
               BITWISE_RATIO, ECDSA_BUILTIN_RATIO, EC_OP_BUILTIN_RATIO,
               EC_OP_SCALAR_HEIGHT, POSEIDON_RATIO,
               DILUTED_CHECK_N_BITS, DILUTED_CHECK_SPACING)
from .air import (
    NPC_PC, NPC_INSTRUCTION, NPC_MEM_OP0_ADDR, NPC_MEM_OP0,
    NPC_MEM_DST_ADDR, NPC_MEM_DST, NPC_MEM_OP1_ADDR, NPC_MEM_OP1,
    NPC_UNUSED_ADDR, NPC_PUBMEM_ADDR, NPC_PUBMEM_VAL,
    NPC_PEDERSEN_IN0_ADDR, NPC_PEDERSEN_IN0_VAL,
    NPC_PEDERSEN_IN1_ADDR, NPC_PEDERSEN_IN1_VAL,
    NPC_PEDERSEN_OUT_ADDR, NPC_PEDERSEN_OUT_VAL,
    NPC_RC128_ADDR, NPC_RC128_VAL,
    NPC_ECDSA_PUBKEY_ADDR, NPC_ECDSA_PUBKEY_VAL,
    NPC_ECDSA_MESSAGE_ADDR, NPC_ECDSA_MESSAGE_VAL,
    NPC_BITWISE_POOL_ADDR, NPC_BITWISE_POOL_VAL,
    NPC_BITWISE_XORY_ADDR, NPC_BITWISE_XORY_VAL,
    NPC_EC_OP_PX_ADDR, NPC_EC_OP_PX_VAL, NPC_EC_OP_PY_ADDR, NPC_EC_OP_PY_VAL,
    NPC_EC_OP_QX_ADDR, NPC_EC_OP_QX_VAL, NPC_EC_OP_QY_ADDR, NPC_EC_OP_QY_VAL,
    NPC_EC_OP_M_ADDR, NPC_EC_OP_M_VAL, NPC_EC_OP_RX_ADDR, NPC_EC_OP_RX_VAL,
    NPC_EC_OP_RY_ADDR, NPC_EC_OP_RY_VAL,
    NPC_POSEIDON_IN0_ADDR, NPC_POSEIDON_IN0_VAL,
    NPC_POSEIDON_IN1_ADDR, NPC_POSEIDON_IN1_VAL,
    NPC_POSEIDON_IN2_ADDR, NPC_POSEIDON_IN2_VAL,
    NPC_POSEIDON_OUT0_ADDR, NPC_POSEIDON_OUT0_VAL,
    NPC_POSEIDON_OUT1_ADDR, NPC_POSEIDON_OUT1_VAL,
    NPC_POSEIDON_OUT2_ADDR, NPC_POSEIDON_OUT2_VAL,
    RC_OFF_DST, RC_ORDERED, RC_OFF_OP1, RC_OFF_OP0, RC_UNUSED, RC16_COMPONENT,
    DIL_UNORDERED, DIL_ORDERED, POS_PARTIAL0, POS_PARTIAL0_SQ,
    AUX_AP, AUX_TMP0, AUX_OP0_MUL_OP1, AUX_FP, AUX_TMP1, AUX_RES,
    PED_BIT251_196_192, PED_BIT251_196, BITWISE_RES_SHIFTED,
    E_PUBKEY_DOUBLING_X, E_PUBKEY_DOUBLING_Y, E_PUBKEY_DOUBLING_SLOPE,
    E_PUBKEY_SUM_X, E_PUBKEY_SUM_Y, E_PUBKEY_SUM_XDIFF_INV,
    E_PUBKEY_SUM_SLOPE, E_R_SUFFIX, E_MESSAGE_SUFFIX,
    E_GEN_SUM_X, E_GEN_SUM_Y, E_GEN_SUM_XDIFF_INV, E_GEN_SUM_SLOPE,
    E_R_POINT_SLOPE, E_R_POINT_XDIFF_INV, E_R_INV, E_W_INV,
    E_MESSAGE_INV, E_PUBKEY_X_SQUARED, E_B_SLOPE, E_B_XDIFF_INV,
    O_Q_DOUBLING_X, O_Q_DOUBLING_Y, O_Q_DOUBLING_SLOPE,
    O_R_SUM_X, O_R_SUM_Y, O_R_SUM_SLOPE, O_R_SUM_XDIFF_INV, O_M_SUFFIX,
    O_M_BIT251_196_192, O_M_BIT251_196,
    POS_FULL0, POS_FULL0_SQ, POS_FULL1, POS_FULL1_SQ, POS_FULL2, POS_FULL2_SQ,
    POS_PARTIAL1, POS_PARTIAL1_SQ,
    PERM_MEM_CELL, PERM_RC_CELL, DIL_AGG_CELL, PERM_DIL_CELL,
    MEMORY_Z, MEMORY_A, RC_Z, DILUTED_PERM_Z, DILUTED_AGG_Z, DILUTED_AGG_A,
    PEDERSEN_STEP_ROWS, RC128_STEP_ROWS, BITWISE_STEP_ROWS,
    ECDSA_STEP_ROWS, EC_OP_STEP_ROWS, POSEIDON_STEP_ROWS,
)
from ... import telemetry
from ...binary.word import decode_words
from ...fields.scan import affine_scan, batch_inv_many, prefix_mul
from ...builtins import pedersen as pedersen_builtin
from ...builtins import bitwise as bitwise_builtin
from ...builtins import ecdsa as ecdsa_builtin
from ...builtins import ec_op as ec_op_builtin
from ...builtins import poseidon as poseidon_builtin
from ..utils import dilute_u16, ordered_with_padding, witness_chunks
from ..utils import ints_to_u64limbs as _ints_to_u64limbs
from ..utils import parse_hex as _parse_hex


def _one_limb(v):
    return _ints_to_u64limbs([v])[0]


def witness_items(priv):
    """The private input's Pedersen, ECDSA and EC-op instances as their
    builtins' batch items (witness_limbs, new_batch), by builtin name."""
    return {
        "pedersen": [(int(i["index"]), _parse_hex(i["x"]), _parse_hex(i["y"]))
                     for i in priv.pedersen],
        "ecdsa": [(int(i["index"]), _parse_hex(i["pubkey"]),
                   _parse_hex(i["msg"]),
                   _parse_hex(i["signature_input"]["r"]),
                   _parse_hex(i["signature_input"]["w"]))
                  for i in priv.ecdsa],
        "ec_op": [(int(i["index"]), *(_parse_hex(i[k]) for k in (
            "p_x", "p_y", "q_x", "q_y", "m"))) for i in priv.ec_op]}


def _windows(dummy, num):
    """[1, ...] limbs of a dummy instance -> [num, ...], one a window."""
    return np.tile(dummy, (num,) + (1,) * (dummy.ndim - 1))


class StarknetExecutionTrace:
    """Built starknet-layout trace: 9 canonical numpy base columns, their
    field tensors on `device`, and the extension-column builder."""

    def __init__(self, F, program, air_public_input, witness, device,
                 request=None):
        """The build is the span "trace.build" of `request` (a new one if
        None), its parts the spans under it."""
        self.request = telemetry.new_request() if request is None \
            else request
        with telemetry.span("trace.build", request=self.request,
                            layout="starknet"), \
                telemetry.Sections() as section:
            self._build(F, program, air_public_input, witness, device,
                        section)

    def _build(self, F, program, air_public_input, witness, device,
               section):
        self.F = F
        self.device = torch.device(device)
        self.program = program
        self.public_input = air_public_input
        p = F.MODULUS

        registers = witness.register_states
        memory = witness.memory
        priv = witness.air_private_input
        num_cycles = len(registers)
        assert num_cycles & (num_cycles - 1) == 0
        n = num_cycles * CYCLE_HEIGHT
        assert n % ECDSA_STEP_ROWS == 0, \
            "starknet layout requires >= 2048 cycles"
        self.trace_len = n

        segments = air_public_input.memory_segments
        init_pedersen = segments["pedersen"].begin_addr
        init_rc = segments["range_check"].begin_addr
        init_ecdsa = segments["ecdsa"].begin_addr
        init_bitwise = segments["bitwise"].begin_addr
        init_ec_op = segments["ec_op"].begin_addr
        init_poseidon = segments["poseidon"].begin_addr

        dec = decode_words(registers, memory, p)

        section("trace.cpu")
        flags_col = np.zeros((n, 4), dtype=np.uint64)
        flags_col[:, 0] = dec.flag_prefixes.astype(np.uint64).reshape(-1)

        pad = air_public_input.public_memory_padding()
        pad_limbs = _one_limb(pad.value)
        npc_col = np.zeros((n, 4), dtype=np.uint64)
        npc_col[0::2, 0] = pad.address
        npc_col[1::2] = pad_limbs

        def set_cell(col, cell, arr, step=CYCLE_HEIGHT):
            col[cell::step] = arr

        def set_cell_small(col, cell, arr, step=CYCLE_HEIGHT):
            col[cell::step] = 0
            col[cell::step, 0] = arr.astype(np.uint64)

        set_cell_small(npc_col, NPC_PC, registers.pc)
        set_cell(npc_col, NPC_INSTRUCTION, dec.instruction)
        set_cell_small(npc_col, NPC_MEM_OP0_ADDR, dec.op0_addr)
        set_cell(npc_col, NPC_MEM_OP0, memory.values[dec.op0_addr])
        set_cell_small(npc_col, NPC_MEM_DST_ADDR, dec.dst_addr)
        set_cell(npc_col, NPC_MEM_DST, memory.values[dec.dst_addr])
        set_cell_small(npc_col, NPC_MEM_OP1_ADDR, dec.op1_addr)
        set_cell(npc_col, NPC_MEM_OP1, memory.values[dec.op1_addr])
        npc_col[NPC_PUBMEM_ADDR::PUBLIC_MEMORY_STEP] = 0
        npc_col[NPC_PUBMEM_VAL::PUBLIC_MEMORY_STEP] = 0

        section("trace.rc_pool")
        # -- rc pool + rc128 dummies ------------------------------------------
        rc128_instances = [(int(i["index"]), _parse_hex(i["value"]))
                           for i in priv.range_check]
        rc128_parts = [
            [(v >> (16 * (RANGE_CHECK_BUILTIN_PARTS - 1 - k))) & 0xFFFF
             for k in range(RANGE_CHECK_BUILTIN_PARTS)]
            for _, v in rc128_instances]
        pool = np.concatenate(
            [dec.off_dst.astype(np.uint32), dec.off_op0.astype(np.uint32),
             dec.off_op1.astype(np.uint32)]
            + [np.asarray(parts, dtype=np.uint32) for parts in rc128_parts])
        ordered_rc, rc_padding = ordered_with_padding(pool)
        rc_min, rc_max = int(ordered_rc[0]), int(ordered_rc[-1])
        assert rc_min == air_public_input.rc_min
        assert rc_max == air_public_input.rc_max
        self.rc_min, self.rc_max = rc_min, rc_max

        num_rc_windows = n // RC128_STEP_ROWS
        num_real_rc = len(rc128_instances)
        assert num_real_rc <= num_rc_windows
        need = (num_rc_windows - num_real_rc) * RANGE_CHECK_BUILTIN_PARTS
        dummy_fill = np.full(need, rc_max, dtype=np.uint64)
        take = min(len(rc_padding), need)
        dummy_fill[:take] = rc_padding[:take]
        leftover_padding = rc_padding[take:]
        dummy_parts = dummy_fill.reshape(-1, RANGE_CHECK_BUILTIN_PARTS)
        all_parts = np.concatenate(
            [np.asarray(rc128_parts, dtype=np.uint64).reshape(
                num_real_rc, RANGE_CHECK_BUILTIN_PARTS),
             dummy_parts]) if num_real_rc else dummy_parts
        rc128_vals = np.zeros((num_rc_windows, 4), dtype=np.uint64)
        for i in range(RANGE_CHECK_BUILTIN_PARTS):
            limb, sh = divmod(16 * (RANGE_CHECK_BUILTIN_PARTS - 1 - i), 64)
            rc128_vals[:, limb] |= all_parts[:, i] << np.uint64(sh)

        rc_col = np.zeros((n, 4), dtype=np.uint64)
        rc_col[:, 0] = rc_max
        set_cell_small(rc_col, RC_OFF_DST, dec.off_dst)
        set_cell_small(rc_col, RC_OFF_OP1, dec.off_op1)
        set_cell_small(rc_col, RC_OFF_OP0, dec.off_op0)
        num_ordered_slots = n // RANGE_CHECK_STEP
        assert len(ordered_rc) <= num_ordered_slots
        ordered_full = np.full(num_ordered_slots, rc_max, dtype=np.uint64)
        ordered_full[: len(ordered_rc)] = ordered_rc
        rc_col[RC_ORDERED::RANGE_CHECK_STEP] = 0
        rc_col[RC_ORDERED::RANGE_CHECK_STEP, 0] = ordered_full
        # rc128 parts at even cycles (cell 12 mod 32)
        rc_col[RC16_COMPONENT::32] = 0
        rc_col[RC16_COMPONENT::32, 0] = all_parts.reshape(-1)
        # leftover rc padding -> odd-cycle Unused cells (cell 28 mod 32)
        unused_slots = np.full(n // 32, rc_max, dtype=np.uint64)
        assert len(leftover_padding) <= len(unused_slots), \
            "rc padding exceeds unused-cell capacity"
        unused_slots[: len(leftover_padding)] = leftover_padding
        rc_col[RC_UNUSED + CYCLE_HEIGHT::32] = 0
        rc_col[RC_UNUSED + CYCLE_HEIGHT::32, 0] = unused_slots
        # clear diluted cells (trace.rs:294-302)
        rc_col[DIL_UNORDERED::DILUTED_CHECK_STEP] = 0
        rc_col[DIL_ORDERED::DILUTED_CHECK_STEP] = 0

        section("trace.limbs")
        aux_col = np.zeros((n, 4), dtype=np.uint64)
        set_cell_small(aux_col, AUX_AP, registers.ap)
        set_cell(aux_col, AUX_TMP0, _ints_to_u64limbs(dec.tmp0))
        set_cell(aux_col, AUX_OP0_MUL_OP1, _ints_to_u64limbs(dec.op0_mul_op1))
        set_cell_small(aux_col, AUX_FP, registers.fp)
        set_cell(aux_col, AUX_TMP1, _ints_to_u64limbs(dec.tmp1))
        set_cell(aux_col, AUX_RES, _ints_to_u64limbs(dec.res))

        # -- pedersen (trace.rs:304-386) ----------------------------------------
        section("trace.builtin.pedersen")
        num_ped = n // PEDERSEN_STEP_ROWS
        items = witness_items(priv)
        ped_instances = items["pedersen"]
        assert len(ped_instances) <= num_ped
        dummy = pedersen_builtin.dummy_limbs()
        # [num_ped, 512, 4]: a window's 512 steps, the dummy's tiled
        psx, psy, suf, slo = (_windows(v, num_ped) for v in (
            dummy.point_x, dummy.point_y, dummy.suffix, dummy.slope))
        ped_a = np.zeros((num_ped, 4), dtype=np.uint64)
        ped_b = np.zeros((num_ped, 4), dtype=np.uint64)
        ped_out = _windows(dummy.output, num_ped)
        # the dummy's (a = b = 0) flags are 0
        bits196 = np.zeros((num_ped, 2, 4), dtype=np.uint64)
        bits192 = np.zeros((num_ped, 2, 4), dtype=np.uint64)
        for chunk in witness_chunks(ped_instances):
            wl = pedersen_builtin.witness_limbs(chunk)
            w = wl.index
            psx[w], psy[w], suf[w], slo[w] = (wl.point_x, wl.point_y,
                                              wl.suffix, wl.slope)
            ped_a[w], ped_b[w], ped_out[w] = wl.a, wl.b, wl.output
            bits196[w, :, 0] = wl.bit251_196
            bits192[w, :, 0] = wl.bit251_196_192
        psx_col, psy_col, suf_col, slo_col = (
            v.reshape(-1, 4) for v in (psx, psy, suf, slo))
        bits196, bits192 = bits196.reshape(-1, 4), bits192.reshape(-1, 4)
        # bit-196 flags overwrite slope cell 255 of each 256-row half
        slo_col[PED_BIT251_196::PEDERSEN_STEP_ROWS // 2] = bits196
        aux_col[PED_BIT251_196_192::PEDERSEN_STEP_ROWS // 2] = bits192

        ped_addrs = init_pedersen + 3 * np.arange(num_ped, dtype=np.uint64)
        set_cell_small(npc_col, NPC_PEDERSEN_IN0_ADDR, ped_addrs,
                       PEDERSEN_STEP_ROWS)
        set_cell(npc_col, NPC_PEDERSEN_IN0_VAL, ped_a, PEDERSEN_STEP_ROWS)
        set_cell_small(npc_col, NPC_PEDERSEN_IN1_ADDR, ped_addrs + 1,
                       PEDERSEN_STEP_ROWS)
        set_cell(npc_col, NPC_PEDERSEN_IN1_VAL, ped_b, PEDERSEN_STEP_ROWS)
        set_cell_small(npc_col, NPC_PEDERSEN_OUT_ADDR, ped_addrs + 2,
                       PEDERSEN_STEP_ROWS)
        set_cell(npc_col, NPC_PEDERSEN_OUT_VAL, ped_out, PEDERSEN_STEP_ROWS)

        section("trace.rc128")
        rc128_addrs = init_rc + np.arange(num_rc_windows, dtype=np.uint64)
        set_cell_small(npc_col, NPC_RC128_ADDR, rc128_addrs, RC128_STEP_ROWS)
        set_cell(npc_col, NPC_RC128_VAL, rc128_vals, RC128_STEP_ROWS)

        # -- ECDSA (trace.rs:428-523) ---------------------------------------------
        section("trace.builtin.ecdsa")
        num_ecdsa = n // ECDSA_STEP_ROWS
        ecdsa_instances = items["ecdsa"]
        assert len(ecdsa_instances) <= num_ecdsa

        def ecdsa_window_arrays(wl):
            """k signatures' limbs -> {(cell, step): [k, rows, 4]} (a
            window's rows of each step column) and {cell: [k, 4]} (the
            specials, one a window)."""
            mads = {E_PUBKEY_SUM_X: 0, E_PUBKEY_SUM_Y: 1,
                    E_PUBKEY_SUM_SLOPE: 4, E_PUBKEY_SUM_XDIFF_INV: 5}
            gens = {E_GEN_SUM_X: 0, E_GEN_SUM_Y: 1, E_GEN_SUM_SLOPE: 4,
                    E_GEN_SUM_XDIFF_INV: 5}
            out = {(cell, 64): wl.doubling[:, :, j] for j, cell in enumerate(
                (E_PUBKEY_DOUBLING_X, E_PUBKEY_DOUBLING_Y,
                 E_PUBKEY_DOUBLING_SLOPE))}
            out.update({(cell, 64): wl.rq_wb[:, :, j]
                        for cell, j in mads.items()})
            out[(E_R_SUFFIX, 64)] = wl.rw_suffix
            out.update({(cell, 128): wl.zg[:, :, j]
                        for cell, j in gens.items()})
            out[(E_MESSAGE_SUFFIX, 128)] = wl.message_suffix
            specials = {cell: wl.single(name) for cell, name in (
                (E_B_SLOPE, "b_slope"), (E_B_XDIFF_INV, "b_x_diff_inv"),
                (E_W_INV, "w_inv"), (E_R_INV, "r_inv"),
                (E_R_POINT_SLOPE, "r_point_slope"),
                (E_R_POINT_XDIFF_INV, "r_point_x_diff_inv"),
                (E_MESSAGE_INV, "message_inv"))}
            specials[E_PUBKEY_X_SQUARED] = wl.pubkey_x_squared
            return out, specials

        dummy_e = ecdsa_builtin.dummy_limbs()
        d_arrays, d_specials = ecdsa_window_arrays(dummy_e)
        ecdsa_windows = {key: _windows(arr, num_ecdsa)
                         for key, arr in d_arrays.items()}
        specials_arr = {cell: _windows(arr, num_ecdsa)
                        for cell, arr in d_specials.items()}
        e_pub = _windows(dummy_e.pubkey_x, num_ecdsa)
        e_msg = _windows(dummy_e.message, num_ecdsa)
        for chunk in witness_chunks(ecdsa_instances):
            wl = ecdsa_builtin.witness_limbs(chunk)
            wi = wl.index
            arrs, specials = ecdsa_window_arrays(wl)
            for key, arr in arrs.items():
                ecdsa_windows[key][wi] = arr
            for cell, arr in specials.items():
                specials_arr[cell][wi] = arr
            e_pub[wi], e_msg[wi] = wl.pubkey_x, wl.message
        for (cell, step), arr in ecdsa_windows.items():
            aux_col[cell::step] = arr.reshape(-1, 4)
        for cell, arr in specials_arr.items():
            aux_col[cell::ECDSA_STEP_ROWS] = arr
        ecdsa_addrs = init_ecdsa + 2 * np.arange(num_ecdsa, dtype=np.uint64)
        set_cell_small(npc_col, NPC_ECDSA_PUBKEY_ADDR, ecdsa_addrs,
                       ECDSA_STEP_ROWS)
        set_cell(npc_col, NPC_ECDSA_PUBKEY_VAL, e_pub, ECDSA_STEP_ROWS)
        set_cell_small(npc_col, NPC_ECDSA_MESSAGE_ADDR, ecdsa_addrs + 1,
                       ECDSA_STEP_ROWS)
        set_cell(npc_col, NPC_ECDSA_MESSAGE_VAL, e_msg, ECDSA_STEP_ROWS)

        section("trace.builtin.bitwise")
        # -- bitwise + diluted pool (trace.rs:525-651) -----------------------------
        num_bw = n // BITWISE_STEP_ROWS
        bw_instances = [(int(i["index"]), _parse_hex(i["x"]), _parse_hex(i["y"]))
                        for i in priv.bitwise]
        assert len(bw_instances) <= num_bw
        bw_vals = np.zeros((num_bw, 5, 4), dtype=np.uint64)
        pool_vals = [np.zeros(68 * (num_bw - len(bw_instances)),
                              dtype=np.uint32)]
        for idx, x, y in bw_instances:
            t = bitwise_builtin.InstanceTrace.new(idx, x, y)
            w = idx
            base = w * BITWISE_STEP_ROWS
            vals_u16 = []
            for pi, dil in enumerate((t.x_dilution, t.y_dilution,
                                      t.x_and_y_dilution, t.x_xor_y_dilution)):
                for j in range(4):
                    for cch in range(4):
                        seg = dil[j * 4 + cch]
                        cell = base + 256 * pi + 1 + 64 * cch + 16 * j
                        rc_col[cell] = 0
                        rc_col[cell, 0] = seg & 0xFFFFFFFFFFFFFFFF
                        vals_u16.append(bitwise_builtin.undilute(seg))
            for j in range(4):
                v = (t.x_and_y_dilution[j * 4 + 3]
                     + t.x_xor_y_dilution[j * 4 + 3])
                s = v << (8 if j == 3 else 4)
                assert s < (1 << 64), "chunk3 top bits nonzero"
                rc_col[base + BITWISE_RES_SHIFTED[j]] = 0
                rc_col[base + BITWISE_RES_SHIFTED[j], 0] = s
                vals_u16.append(bitwise_builtin.undilute(s))
            pool_vals.append(np.asarray(vals_u16, dtype=np.uint32))
            for k, v in enumerate((t.x, t.y, t.x_and_y, t.x_xor_y, t.x_or_y)):
                bw_vals[w, k] = _one_limb(v)
        section("trace.diluted")
        pool = np.concatenate(pool_vals)
        diluted_max = (1 << DILUTED_CHECK_N_BITS) - 1
        ordered_dil, dil_padding = ordered_with_padding(pool, 0, diluted_max)

        bw_pool_addrs = (init_bitwise
                         + 5 * np.arange(num_bw, dtype=np.uint64)[:, None]
                         + np.arange(4, dtype=np.uint64)[None, :])
        addr_step = BITWISE_STEP_ROWS // 4
        set_cell_small(npc_col, NPC_BITWISE_POOL_ADDR,
                       bw_pool_addrs.reshape(-1), addr_step)
        set_cell(npc_col, NPC_BITWISE_POOL_VAL,
                 bw_vals[:, :4].reshape(-1, 4), addr_step)
        set_cell_small(npc_col, NPC_BITWISE_XORY_ADDR,
                       init_bitwise + 4
                       + 5 * np.arange(num_bw, dtype=np.uint64),
                       BITWISE_STEP_ROWS)
        set_cell(npc_col, NPC_BITWISE_XORY_VAL, bw_vals[:, 4],
                 BITWISE_STEP_ROWS)

        # diluted padding: odd 8-row steps (cells 8i+1, i odd) excluding the
        # shifted-uniqueness cells (trace.rs:668-693)
        free_offs = np.asarray(
            [8 * i + DIL_UNORDERED for i in range(1, 128, 2)
             if 8 * i + DIL_UNORDERED not in BITWISE_RES_SHIFTED],
            dtype=np.int64)
        slots = (np.arange(num_bw, dtype=np.int64)[:, None]
                 * BITWISE_STEP_ROWS + free_offs[None, :]).reshape(-1)
        assert len(dil_padding) <= len(slots), "diluted padding overflow"
        rc_col[slots[: len(dil_padding)], 0] = \
            dilute_u16(dil_padding, DILUTED_CHECK_SPACING)
        rc_col[slots[: len(dil_padding)], 1:] = 0

        num_dil_slots = n // DILUTED_CHECK_STEP
        assert len(ordered_dil) <= num_dil_slots, \
            "ordered diluted values overflow trace"
        start = (num_dil_slots - len(ordered_dil)) * DILUTED_CHECK_STEP \
            + DIL_ORDERED
        rc_col[start::DILUTED_CHECK_STEP] = 0
        rc_col[start::DILUTED_CHECK_STEP, 0] = \
            dilute_u16(ordered_dil, DILUTED_CHECK_SPACING)

        # -- EC-op (trace.rs:707-777; AFTER ecdsa — overwrites repurposed cells) --
        section("trace.builtin.ec_op")
        num_ec_op = n // EC_OP_STEP_ROWS
        ec_op_instances = items["ec_op"]
        assert len(ec_op_instances) <= num_ec_op

        def ec_op_window_arrays(wl):
            """k EC ops' limbs -> {cell: [k, 256, 4]}.  The last step's
            slope and x_diff_inv cells are repurposed by the ECDSA
            specials, which were written already: the write below skips
            them (trace.rs:747-751)."""
            out = {cell: wl.q_doubling[:, :, j] for j, cell in enumerate(
                (O_Q_DOUBLING_X, O_Q_DOUBLING_Y, O_Q_DOUBLING_SLOPE))}
            out.update({cell: wl.r_steps[:, :, j] for cell, j in (
                (O_R_SUM_X, 0), (O_R_SUM_Y, 1), (O_R_SUM_SLOPE, 4),
                (O_R_SUM_XDIFF_INV, 5))})
            out[O_M_SUFFIX] = wl.m_suffix
            return out

        dummy_o = ec_op_builtin.dummy_limbs()
        ec_op_cols = {cell: _windows(arr, num_ec_op)
                      for cell, arr in ec_op_window_arrays(dummy_o).items()}
        o_bits192 = np.zeros((num_ec_op, 4), dtype=np.uint64)
        o_bits196 = np.zeros((num_ec_op, 4), dtype=np.uint64)
        o_bits192[:, 0] = dummy_o.bit251_196_192[0]
        o_bits196[:, 0] = dummy_o.bit251_196[0]
        # [num_ec_op, 7, 4]: px, py, qx, qy, m, rx, ry
        o_vals = _windows(np.concatenate([dummy_o.inputs, dummy_o.r], 1),
                          num_ec_op)
        for chunk in witness_chunks(ec_op_instances):
            wl = ec_op_builtin.witness_limbs(chunk)
            wi = wl.index
            for cell, arr in ec_op_window_arrays(wl).items():
                ec_op_cols[cell][wi] = arr
            o_bits192[wi, 0] = wl.bit251_196_192
            o_bits196[wi, 0] = wl.bit251_196
            o_vals[wi] = np.concatenate([wl.inputs, wl.r], 1)
        ec_op_cols = {cell: arr.reshape(-1, 4)
                      for cell, arr in ec_op_cols.items()}
        for cell, arr in ec_op_cols.items():
            if cell in (O_R_SUM_SLOPE, O_R_SUM_XDIFF_INV):
                # skip step 255 (repurposed by ECDSA; trace.rs:747-751)
                keep = np.ones(256 * num_ec_op, dtype=bool)
                keep[255::256] = False
                rows = np.arange(n)[cell::64][keep]
                aux_col[rows] = arr[keep]
            else:
                aux_col[cell::64] = arr
        aux_col[O_M_BIT251_196_192::EC_OP_STEP_ROWS] = o_bits192
        aux_col[O_M_BIT251_196::EC_OP_STEP_ROWS] = o_bits196
        ec_op_addrs = init_ec_op + 7 * np.arange(num_ec_op, dtype=np.uint64)
        for off, (acell, vcell) in enumerate([
                (NPC_EC_OP_PX_ADDR, NPC_EC_OP_PX_VAL),
                (NPC_EC_OP_PY_ADDR, NPC_EC_OP_PY_VAL),
                (NPC_EC_OP_QX_ADDR, NPC_EC_OP_QX_VAL),
                (NPC_EC_OP_QY_ADDR, NPC_EC_OP_QY_VAL),
                (NPC_EC_OP_M_ADDR, NPC_EC_OP_M_VAL),
                (NPC_EC_OP_RX_ADDR, NPC_EC_OP_RX_VAL),
                (NPC_EC_OP_RY_ADDR, NPC_EC_OP_RY_VAL)]):
            set_cell_small(npc_col, acell, ec_op_addrs + off, EC_OP_STEP_ROWS)
            set_cell(npc_col, vcell, o_vals[:, off], EC_OP_STEP_ROWS)

        section("trace.builtin.poseidon")
        # -- poseidon (trace.rs:779-888) --------------------------------------------
        num_pos = n // POSEIDON_STEP_ROWS
        pos_instances = [
            (int(i["index"]), _parse_hex(i["input_s0"]),
             _parse_hex(i["input_s1"]), _parse_hex(i["input_s2"]))
            for i in priv.poseidon]
        assert len(pos_instances) <= num_pos

        def pos_window_arrays(t):
            full = (t.full_round_states_1st_half
                    + t.full_round_states_2nd_half)
            out = {}
            for s, (cell, sq_cell) in enumerate(
                    [(POS_FULL0, POS_FULL0_SQ), (POS_FULL1, POS_FULL1_SQ),
                     (POS_FULL2, POS_FULL2_SQ)]):
                vals = [fr.after_add_round_keys[s] for fr in full]
                out[("aux", cell, 64)] = _ints_to_u64limbs(vals)
                out[("aux", sq_cell, 64)] = _ints_to_u64limbs(
                    [v * v % p for v in vals])
            p0 = t.partial_round_states[:64]
            out[("rc", POS_PARTIAL0, 8)] = _ints_to_u64limbs(p0)
            out[("rc", POS_PARTIAL0_SQ, 8)] = _ints_to_u64limbs(
                [v * v % p for v in p0])
            # 22 written slots of 32 per window; the rest stay zero
            # (reference zips aux 16-row chunks with states[61..])
            p1 = t.partial_round_states[61:] + [0] * 10
            out[("aux", POS_PARTIAL1, 16)] = _ints_to_u64limbs(p1)
            out[("aux", POS_PARTIAL1_SQ, 16)] = _ints_to_u64limbs(
                [v * v % p for v in p1])
            return out

        dummy_p = poseidon_builtin.InstanceTrace.new_dummy(0)
        d_arrays = pos_window_arrays(dummy_p)
        pos_cols = {key: np.tile(arr, (num_pos, 1))
                    for key, arr in d_arrays.items()}
        pos_io = {k: np.tile(_one_limb(v), (num_pos, 1)) for k, v in (
            ("i0", dummy_p.input0), ("i1", dummy_p.input1),
            ("i2", dummy_p.input2), ("o0", dummy_p.output0),
            ("o1", dummy_p.output1), ("o2", dummy_p.output2))}
        for idx, i0, i1, i2 in pos_instances:
            t = poseidon_builtin.InstanceTrace.new(idx, i0, i1, i2)
            wi = idx
            for key, arr in pos_window_arrays(t).items():
                per = arr.shape[0]
                pos_cols[key][per * wi:per * (wi + 1)] = arr
            for k, v in (("i0", t.input0), ("i1", t.input1), ("i2", t.input2),
                         ("o0", t.output0), ("o1", t.output1),
                         ("o2", t.output2)):
                pos_io[k][wi] = _one_limb(v)
        for (which, cell, step), arr in pos_cols.items():
            col = aux_col if which == "aux" else rc_col
            col[cell::step] = arr
        pos_addrs = init_poseidon + 6 * np.arange(num_pos, dtype=np.uint64)
        for off, (acell, vcell, key) in enumerate([
                (NPC_POSEIDON_IN0_ADDR, NPC_POSEIDON_IN0_VAL, "i0"),
                (NPC_POSEIDON_IN1_ADDR, NPC_POSEIDON_IN1_VAL, "i1"),
                (NPC_POSEIDON_IN2_ADDR, NPC_POSEIDON_IN2_VAL, "i2"),
                (NPC_POSEIDON_OUT0_ADDR, NPC_POSEIDON_OUT0_VAL, "o0"),
                (NPC_POSEIDON_OUT1_ADDR, NPC_POSEIDON_OUT1_VAL, "o1"),
                (NPC_POSEIDON_OUT2_ADDR, NPC_POSEIDON_OUT2_VAL, "o2")]):
            set_cell_small(npc_col, acell, pos_addrs + off, POSEIDON_STEP_ROWS)
            set_cell(npc_col, vcell, pos_io[key], POSEIDON_STEP_ROWS)

        section("trace.memory")
        # -- memory gaps + ordered memory ------------------------------------------
        pub = air_public_input.public_memory
        pub_addrs = np.array([e.address for e in pub], dtype=np.uint64)
        uniq = np.unique(np.concatenate([npc_col[0::2, 0], pub_addrs]))
        full = np.arange(uniq[0], uniq[-1] + 1, dtype=np.uint64)
        present = np.zeros(len(full), dtype=bool)
        present[(uniq - uniq[0]).astype(np.int64)] = True
        missing = full[~present]
        assert len(missing) <= num_cycles, "too many memory gaps for trace"
        gap_rows = NPC_UNUSED_ADDR + CYCLE_HEIGHT * np.arange(len(missing))
        npc_col[gap_rows] = 0
        npc_col[gap_rows, 0] = missing
        npc_col[gap_rows + 1] = 0

        pub_vals = _ints_to_u64limbs([e.value for e in pub])
        num_pub_cells = n // PUBLIC_MEMORY_STEP
        n_extra_pad = num_pub_cells - len(pub)
        assert n_extra_pad >= 0
        all_addr = np.concatenate([
            npc_col[0::2, 0],
            np.full(n_extra_pad, pad.address, dtype=np.uint64), pub_addrs])
        all_val = np.concatenate([
            npc_col[1::2],
            np.broadcast_to(pad_limbs, (n_extra_pad, 4)), pub_vals])
        order = np.argsort(all_addr, kind="stable")
        all_addr, all_val = all_addr[order], all_val[order]
        assert (all_addr[:num_pub_cells] == 0).all()
        all_addr = all_addr[num_pub_cells:]
        all_val = all_val[num_pub_cells:]
        assert all_addr[0] == 1, "first memory address must be 1"
        d = np.diff(all_addr)
        assert np.isin(d, (0, 1)).all(), "memory must be continuous"
        same = np.nonzero(d == 0)[0]
        assert (all_val[same] == all_val[same + 1]).all(), \
            "memory must be single-valued"
        mem_col = np.zeros((n, 4), dtype=np.uint64)
        mem_col[0::2, 0] = all_addr
        mem_col[1::2] = all_val

        self.base_cols_canonical = {
            0: flags_col, 1: psx_col, 2: psy_col, 3: suf_col, 4: slo_col,
            5: npc_col, 6: mem_col, 7: rc_col, 8: aux_col,
        }
        self._device_cols = None
        self.initial_registers = registers.arr[0]
        self.final_registers = registers.arr[-1]

    def base_columns(self):
        """dict col -> [n, L] field tensors on the trace's device."""
        if self._device_cols is None:
            from ..utils import upload_base_columns
            self._device_cols = upload_base_columns(
                self.F, self.base_cols_canonical, self.device)
        return self._device_cols

    def build_extension_columns(self, challenges):
        """The one permutation column 9 from challenges (python ints;
        trace.rs:997-1100).  Returns {9: [n, L] tensor}."""
        F = self.F
        cols = self.base_columns()
        ch = F.encode_ints([challenges[i] for i in (
            MEMORY_Z, MEMORY_A, RC_Z, DILUTED_PERM_Z, DILUTED_AGG_Z,
            DILUTED_AGG_A)], self.device)
        return _build_extension_columns(F, cols[5], cols[6], cols[7],
                                        *ch.unbind(0))


def _build_extension_columns(F, npc_dev, mem_dev, rc_dev,
                             z_mem, a_mem, z_rc, z_dp, z_da, a_da):
    n = npc_dev.shape[0]
    device = npc_dev.device

    # memory permutation: prod (z - (a + alpha v)) / (z - (a' + alpha v'))
    a, v = npc_dev[0::2], npc_dev[1::2]
    ap_, vp = mem_dev[0::2], mem_dev[1::2]
    num = F.sub(z_mem, F.add(a, F.mul(a_mem, v)))
    den = F.sub(z_mem, F.add(ap_, F.mul(a_mem, vp)))

    # 16-bit range-check permutation: unordered cells 0 mod 4, ordered 2
    num_rc = F.sub(z_rc, rc_dev[0::RANGE_CHECK_STEP])
    den_rc = F.sub(z_rc, rc_dev[RC_ORDERED::RANGE_CHECK_STEP])

    # diluted permutation: unordered cells 1 mod 8, ordered 5 mod 8
    dil_un = rc_dev[DIL_UNORDERED::DILUTED_CHECK_STEP]
    dil_ord = rc_dev[DIL_ORDERED::DILUTED_CHECK_STEP]
    num_d = F.sub(z_dp, dil_un)
    den_d = F.sub(z_dp, dil_ord)

    # the three denominators inverted in one call
    inv, inv_rc, inv_d = batch_inv_many(F, [den, den_rc, den_d])
    mem_cum = prefix_mul(F, F.mul(num, inv))
    rc_cum = prefix_mul(F, F.mul(num_rc, inv_rc))
    dil_cum = prefix_mul(F, F.mul(num_d, inv_d))

    # diluted aggregate: acc0 = 1; acc' = acc (1 + z u) + alpha u^2, an
    # affine recurrence: the map acc -> acc a + b, scanned by composition
    # (first (a1, b1), then (a2, b2)) = (a1 a2, b1 a2 + b2); acc_k is then
    # a + b of the composed map, applied to acc0 = 1 (fields/scan.py
    # affine_scan: one fp252_affine_scan launch on the card)
    u = F.sub(dil_ord[1:], dil_ord[:-1])
    a_seq = F.add(F.ones(u.shape[:-1], device), F.mul(z_da, u))
    b_seq = F.mul(a_da, F.mul(u, u))
    agg = affine_scan(F, a_seq, b_seq)

    perm = F.zeros((n,), device)
    perm[PERM_MEM_CELL::MEMORY_STEP] = mem_cum
    perm[PERM_RC_CELL::RANGE_CHECK_STEP] = rc_cum
    perm[PERM_DIL_CELL::DILUTED_CHECK_STEP] = dil_cum
    perm[DIL_AGG_CELL::DILUTED_CHECK_STEP] = agg
    return {9: perm}
