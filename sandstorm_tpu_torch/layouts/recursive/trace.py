"""Execution trace of the recursive layout (port of
sandstorm_tpu/layouts/recursive/trace.py).

The trace is built on the host with numpy, exactly as the JAX package builds
it, which follows the reference sandstorm's layouts/src/recursive/trace.rs:
the same virtual-column cell placement (see air.py's column map), rc128
dummy-instance stuffing with rc padding values, pedersen dummy instances
filling every 2048-row window, bitwise dilution segments + shifted
uniqueness cells + diluted pool, diluted padding distribution, memory gap
fill via (UnusedAddr, UnusedVal) cells, and ordered-memory construction.
The columns are uploaded to the trace's device in one copy; the extension
columns are built there: the permutation products as running products
with one batch inversion each, and the diluted aggregate's affine
recurrence acc' = acc (1 + z u) + alpha u^2 as a prefix scan over the
composition of affine maps.
"""

import numpy as np
import torch

from . import (CYCLE_HEIGHT, PUBLIC_MEMORY_STEP, MEMORY_STEP,
               RANGE_CHECK_STEP, PEDERSEN_BUILTIN_RATIO,
               RANGE_CHECK_BUILTIN_RATIO, RANGE_CHECK_BUILTIN_PARTS,
               BITWISE_RATIO, DILUTED_CHECK_N_BITS, DILUTED_CHECK_SPACING)
from .air import (
    NPC_PC, NPC_INSTRUCTION, NPC_MEM_OP0_ADDR, NPC_MEM_OP0,
    NPC_MEM_DST_ADDR, NPC_MEM_DST, NPC_MEM_OP1_ADDR, NPC_MEM_OP1,
    NPC_UNUSED_ADDR, NPC_PEDERSEN_IN0_ADDR, NPC_PEDERSEN_IN0_VAL,
    NPC_PEDERSEN_IN1_ADDR, NPC_PEDERSEN_IN1_VAL,
    NPC_PEDERSEN_OUT_ADDR, NPC_PEDERSEN_OUT_VAL,
    NPC_RC128_ADDR, NPC_RC128_VAL,
    NPC_BITWISE_POOL_ADDR, NPC_BITWISE_POOL_VAL,
    NPC_BITWISE_XORY_ADDR, NPC_BITWISE_XORY_VAL,
    RC_OFF_DST, RC_ORDERED, RC_OFF_OP1, RC_OFF_OP0, RC16_COMPONENT,
    AUX_AP, AUX_TMP0, AUX_OP0_MUL_OP1, AUX_FP, AUX_TMP1, AUX_RES,
    PED_SUFFIX, PED_SLOPE, PED_PSUM_X, PED_PSUM_Y,
    PED_BIT251_196_192, PED_BIT251_196, BITWISE_RES_SHIFTED,
    MEMORY_Z, MEMORY_A, RC_Z, DILUTED_PERM_Z, DILUTED_AGG_Z, DILUTED_AGG_A,
    PEDERSEN_STEP_ROWS, BITWISE_STEP_ROWS, RC128_STEP_ROWS,
)
from ...binary.word import decode_words
from ...fields.scan import batch_inv_many, prefix_mul, prefix_scan
from ...builtins import pedersen as pedersen_builtin
from ...builtins import bitwise as bitwise_builtin
from ..utils import dilute_u16, ordered_with_padding, witness_chunks
from ..utils import ints_to_u64limbs as _ints_to_u64limbs
from ..utils import parse_hex as _parse_hex


class RecursiveExecutionTrace:
    """Built recursive-layout trace: 7 canonical numpy base columns, their
    field tensors on `device`, and the extension-column builder."""

    def __init__(self, F, program, air_public_input, witness, device):
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
        assert n % (2 * PEDERSEN_STEP_ROWS) == 0, \
            "recursive layout requires >= 256 cycles"
        self.trace_len = n

        segments = air_public_input.memory_segments
        initial_pedersen_addr = segments["pedersen"].begin_addr
        initial_rc_addr = segments["range_check"].begin_addr
        initial_bitwise_addr = segments["bitwise"].begin_addr

        dec = decode_words(registers, memory, p)

        # -- flags column ----------------------------------------------------
        flags_col = np.zeros((n, 4), dtype=np.uint64)
        flags_col[:, 0] = dec.flag_prefixes.astype(np.uint64).reshape(-1)

        # -- npc column (cpu cells; pub-mem pair zeroed at (2,3)/cycle) -------
        pad = air_public_input.public_memory_padding()
        pad_limbs = _ints_to_u64limbs([pad.value])[0]
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
        npc_col[2::PUBLIC_MEMORY_STEP] = 0
        npc_col[3::PUBLIC_MEMORY_STEP] = 0

        # -- range-check pool: cpu offsets + 128-bit rc builtin parts ---------
        rc128_instances = [(int(inst["index"]), _parse_hex(inst["value"]))
                           for inst in priv.range_check]
        rc128_parts = [
            [(v >> (16 * (RANGE_CHECK_BUILTIN_PARTS - 1 - i))) & 0xFFFF
             for i in range(RANGE_CHECK_BUILTIN_PARTS)]
            for _, v in rc128_instances]
        pool = np.concatenate(
            [dec.off_dst.astype(np.uint32), dec.off_op0.astype(np.uint32),
             dec.off_op1.astype(np.uint32)]
            + [np.asarray(parts, dtype=np.uint32) for parts in rc128_parts])
        ordered_rc, rc_padding = ordered_with_padding(pool)
        rc_min, rc_max = int(ordered_rc[0]), int(ordered_rc[-1])
        assert rc_min == air_public_input.rc_min, \
            (rc_min, air_public_input.rc_min)
        assert rc_max == air_public_input.rc_max, \
            (rc_max, air_public_input.rc_max)
        self.rc_min, self.rc_max = rc_min, rc_max

        # rc128 dummy instances consume rc padding values 8 at a time
        # (recursive/trace.rs:234-249), then rc_max once they run out
        num_rc_windows = n // RC128_STEP_ROWS
        num_real_rc = len(rc128_instances)
        assert num_real_rc <= num_rc_windows
        need = (num_rc_windows - num_real_rc) * RANGE_CHECK_BUILTIN_PARTS
        assert len(rc_padding) <= need, \
            "rc padding exceeds dummy-instance capacity"
        padded = np.full(need, rc_max, dtype=np.uint64)
        padded[: len(rc_padding)] = rc_padding
        dummy_parts = padded.reshape(-1, RANGE_CHECK_BUILTIN_PARTS)
        all_parts = np.concatenate(
            [np.asarray(rc128_parts, dtype=np.uint64).reshape(
                num_real_rc, RANGE_CHECK_BUILTIN_PARTS),
             dummy_parts]) if num_real_rc else dummy_parts
        # recompose each window's 128-bit value into u64 limbs (big-endian
        # parts: value = sum part_i << (16*(7-i)))
        rc128_vals = np.zeros((num_rc_windows, 4), dtype=np.uint64)
        for i in range(RANGE_CHECK_BUILTIN_PARTS):
            limb, sh = divmod(16 * (RANGE_CHECK_BUILTIN_PARTS - 1 - i), 64)
            rc128_vals[:, limb] |= all_parts[:, i] << np.uint64(sh)

        # -- range-check column ------------------------------------------------
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
        rc_col[RC16_COMPONENT::CYCLE_HEIGHT] = 0
        rc_col[RC16_COMPONENT::CYCLE_HEIGHT, 0] = all_parts.reshape(-1)

        # -- auxiliary column ---------------------------------------------------
        aux_col = np.zeros((n, 4), dtype=np.uint64)
        set_cell_small(aux_col, AUX_AP, registers.ap)
        set_cell(aux_col, AUX_TMP0, _ints_to_u64limbs(dec.tmp0))
        set_cell(aux_col, AUX_OP0_MUL_OP1, _ints_to_u64limbs(dec.op0_mul_op1))
        set_cell_small(aux_col, AUX_FP, registers.fp)
        set_cell(aux_col, AUX_TMP1, _ints_to_u64limbs(dec.tmp1))
        set_cell(aux_col, AUX_RES, _ints_to_u64limbs(dec.res))

        # -- pedersen builtin (recursive/trace.rs:289-371) ------------------------
        num_ped_windows = n // PEDERSEN_STEP_ROWS
        ped_instances = [(int(i["index"]), _parse_hex(i["x"]), _parse_hex(i["y"]))
                         for i in priv.pedersen]
        assert len(ped_instances) <= num_ped_windows
        dummy = pedersen_builtin.dummy_limbs()
        # [windows, 512, 4]: a window's 512 steps, the dummy's tiled
        psx, psy, suf, slo = (np.tile(v, (num_ped_windows, 1, 1)) for v in (
            dummy.point_x, dummy.point_y, dummy.suffix, dummy.slope))
        ped_a = np.zeros((num_ped_windows, 4), dtype=np.uint64)
        ped_b = np.zeros((num_ped_windows, 4), dtype=np.uint64)
        ped_out = np.tile(dummy.output, (num_ped_windows, 1))
        # the dummy's (a = b = 0) flags are 0
        bits196 = np.zeros((num_ped_windows, 2, 4), dtype=np.uint64)
        bits192 = np.zeros((num_ped_windows, 2, 4), dtype=np.uint64)
        for chunk in witness_chunks(ped_instances):
            wl = pedersen_builtin.witness_limbs(chunk)
            w = wl.index
            psx[w], psy[w], suf[w], slo[w] = (wl.point_x, wl.point_y,
                                              wl.suffix, wl.slope)
            ped_a[w], ped_b[w], ped_out[w] = wl.a, wl.b, wl.output
            bits196[w, :, 0] = wl.bit251_196
            bits192[w, :, 0] = wl.bit251_196_192
        bits196, bits192 = bits196.reshape(-1, 4), bits192.reshape(-1, 4)
        rc_col[PED_PSUM_X::4] = psx.reshape(-1, 4)
        rc_col[PED_PSUM_Y::4] = psy.reshape(-1, 4)
        aux_col[PED_SUFFIX::4] = suf.reshape(-1, 4)
        aux_col[PED_SLOPE::4] = slo.reshape(-1, 4)
        # bit flags overwrite slope cells 7 / 1022 of each 1024-row half
        # (slope at step 255 is always 0 — bit 255 of a felt is never set)
        aux_col[PED_BIT251_196_192::PEDERSEN_STEP_ROWS // 2] = bits192
        aux_col[PED_BIT251_196::PEDERSEN_STEP_ROWS // 2] = bits196

        ped_addrs = (initial_pedersen_addr
                     + 3 * np.arange(num_ped_windows, dtype=np.uint64))
        set_cell_small(npc_col, NPC_PEDERSEN_IN0_ADDR, ped_addrs,
                       PEDERSEN_STEP_ROWS)
        set_cell(npc_col, NPC_PEDERSEN_IN0_VAL, ped_a, PEDERSEN_STEP_ROWS)
        set_cell_small(npc_col, NPC_PEDERSEN_IN1_ADDR, ped_addrs + 1,
                       PEDERSEN_STEP_ROWS)
        set_cell(npc_col, NPC_PEDERSEN_IN1_VAL, ped_b, PEDERSEN_STEP_ROWS)
        set_cell_small(npc_col, NPC_PEDERSEN_OUT_ADDR, ped_addrs + 2,
                       PEDERSEN_STEP_ROWS)
        set_cell(npc_col, NPC_PEDERSEN_OUT_VAL, ped_out, PEDERSEN_STEP_ROWS)

        # rc128 builtin memory cells
        rc128_addrs = (initial_rc_addr
                       + np.arange(num_rc_windows, dtype=np.uint64))
        set_cell_small(npc_col, NPC_RC128_ADDR, rc128_addrs, RC128_STEP_ROWS)
        set_cell(npc_col, NPC_RC128_VAL, rc128_vals, RC128_STEP_ROWS)

        # -- bitwise builtin + diluted pool (recursive/trace.rs:413-540) ----------
        num_bw_windows = n // BITWISE_STEP_ROWS
        bw_instances = [(int(i["index"]), _parse_hex(i["x"]), _parse_hex(i["y"]))
                        for i in priv.bitwise]
        assert len(bw_instances) <= num_bw_windows
        diluted_un_col = np.zeros((n, 4), dtype=np.uint64)
        # x, y, x&y, x|y, x^y per window ([W, 4] limb arrays)
        bw_vals = np.zeros((num_bw_windows, 5, 4), dtype=np.uint64)
        pool_vals = []
        num_dummy_bw = num_bw_windows - len(bw_instances)
        # dummy instances contribute 68 zero pool values each
        pool_vals.append(np.zeros(68 * num_dummy_bw, dtype=np.uint32))
        for idx, x, y in bw_instances:
            t = bitwise_builtin.InstanceTrace.new(idx, x, y)
            w = idx
            base = w * BITWISE_STEP_ROWS
            vals_u16 = []
            for pi, dil in enumerate((t.x_dilution, t.y_dilution,
                                      t.x_and_y_dilution, t.x_xor_y_dilution)):
                for j in range(4):          # spacing offset
                    for cch in range(4):    # 64-bit chunk
                        seg = dil[j * 4 + cch]
                        cell = base + 32 * pi + 8 * cch + 2 * j
                        diluted_un_col[cell, 0] = seg & 0xFFFFFFFFFFFFFFFF
                        vals_u16.append(bitwise_builtin.undilute(seg))
            # shifted uniqueness cells (x&y + x^y of chunk3, shifted)
            for j in range(4):
                v = (t.x_and_y_dilution[j * 4 + 3]
                     + t.x_xor_y_dilution[j * 4 + 3])
                s = v << (8 if j == 3 else 4)
                assert s < (1 << 64), "chunk3 top bits nonzero (AIR would fail)"
                diluted_un_col[base + BITWISE_RES_SHIFTED[j], 0] = s
                vals_u16.append(bitwise_builtin.undilute(s))
            pool_vals.append(np.asarray(vals_u16, dtype=np.uint32))
            for k, v in enumerate((t.x, t.y, t.x_and_y, t.x_xor_y, t.x_or_y)):
                bw_vals[w, k] = _ints_to_u64limbs([v])[0]
        pool = np.concatenate(pool_vals)
        diluted_max = (1 << DILUTED_CHECK_N_BITS) - 1
        ordered_dil, dil_padding = ordered_with_padding(pool, 0, diluted_max)

        bw_pool_addrs = (initial_bitwise_addr
                         + 5 * np.arange(num_bw_windows, dtype=np.uint64)
                         [:, None] + np.arange(4, dtype=np.uint64)[None, :])
        addr_step = BITWISE_STEP_ROWS // 4
        set_cell_small(npc_col, NPC_BITWISE_POOL_ADDR,
                       bw_pool_addrs.reshape(-1), addr_step)
        set_cell(npc_col, NPC_BITWISE_POOL_VAL,
                 bw_vals[:, :4].reshape(-1, 4), addr_step)
        set_cell_small(npc_col, NPC_BITWISE_XORY_ADDR,
                       (initial_bitwise_addr + 4
                        + 5 * np.arange(num_bw_windows, dtype=np.uint64)),
                       BITWISE_STEP_ROWS)
        set_cell(npc_col, NPC_BITWISE_XORY_VAL, bw_vals[:, 4],
                 BITWISE_STEP_ROWS)

        # diluted padding -> unwritten odd cells of the unordered column
        # (ascending within each 128-row window; recursive/trace.rs:557-592)
        free_offs = np.asarray(
            [o for o in range(1, BITWISE_STEP_ROWS, 2)
             if o not in BITWISE_RES_SHIFTED], dtype=np.int64)
        slots = (np.arange(num_bw_windows, dtype=np.int64)[:, None]
                 * BITWISE_STEP_ROWS + free_offs[None, :]).reshape(-1)
        assert len(dil_padding) <= len(slots), "diluted padding overflow"
        diluted_un_col[slots[: len(dil_padding)], 0] = \
            dilute_u16(dil_padding, DILUTED_CHECK_SPACING)

        # ordered diluted values sit at the END of the ordered column
        diluted_ord_col = np.zeros((n, 4), dtype=np.uint64)
        assert len(ordered_dil) <= n, "ordered diluted values overflow trace"
        diluted_ord_col[n - len(ordered_dil):, 0] = \
            dilute_u16(ordered_dil, DILUTED_CHECK_SPACING)

        # -- memory gap fill (UnusedAddr/Val cells; trace.rs:598-629) --------------
        pub = air_public_input.public_memory
        pub_addrs = np.array([e.address for e in pub], dtype=np.uint64)
        acc_addrs = np.concatenate([npc_col[0::2, 0], pub_addrs])
        uniq = np.unique(acc_addrs)
        full = np.arange(uniq[0], uniq[-1] + 1, dtype=np.uint64)
        present = np.zeros(len(full), dtype=bool)
        present[(uniq - uniq[0]).astype(np.int64)] = True
        missing = full[~present]
        assert len(missing) <= num_cycles, "too many memory gaps for trace"
        gap_rows = NPC_UNUSED_ADDR + CYCLE_HEIGHT * np.arange(len(missing))
        npc_col[gap_rows] = 0
        npc_col[gap_rows, 0] = missing
        npc_col[gap_rows + 1] = 0

        # -- ordered memory accesses (layouts/src/utils.rs:116-154) ---------------
        pub_vals = _ints_to_u64limbs([e.value for e in pub])
        num_pub_cells = n // PUBLIC_MEMORY_STEP
        n_extra_pad = num_pub_cells - len(pub)
        assert n_extra_pad >= 0
        all_addr = np.concatenate([
            npc_col[0::2, 0],
            np.full(n_extra_pad, pad.address, dtype=np.uint64),
            pub_addrs])
        all_val = np.concatenate([
            npc_col[1::2],
            np.broadcast_to(pad_limbs, (n_extra_pad, 4)),
            pub_vals])
        order = np.argsort(all_addr, kind="stable")
        all_addr, all_val = all_addr[order], all_val[order]
        assert (all_addr[:num_pub_cells] == 0).all(), \
            "expected address-0 entries from public memory cells"
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
            0: flags_col, 1: diluted_un_col, 2: diluted_ord_col,
            3: npc_col, 4: mem_col, 5: rc_col, 6: aux_col,
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
        """Extension columns 7/8/9 from challenges (python ints;
        trace.rs:699-814).  Returns {7, 8, 9: [n, L] tensors}."""
        F = self.F
        cols = self.base_columns()
        ch = F.encode_ints([challenges[i] for i in (
            MEMORY_Z, MEMORY_A, RC_Z, DILUTED_PERM_Z, DILUTED_AGG_Z,
            DILUTED_AGG_A)], self.device)
        return _build_extension_columns(
            F, cols[1], cols[2], cols[3], cols[4], cols[5], *ch.unbind(0))


def _build_extension_columns(F, dil_un, dil_ord, npc_dev, mem_dev, rc_dev,
                             z_mem, a_mem, z_rc, z_dp, z_da, a_da):
    n = npc_dev.shape[0]

    # memory permutation: prod (z - (a + alpha v)) / (z - (a' + alpha v'))
    a, v = npc_dev[0::2], npc_dev[1::2]
    ap_, vp = mem_dev[0::2], mem_dev[1::2]
    num = F.sub(z_mem, F.add(a, F.mul(a_mem, v)))
    den = F.sub(z_mem, F.add(ap_, F.mul(a_mem, vp)))

    # 16-bit range-check permutation: unordered cells 0 mod 4, ordered 2 mod 4
    num_rc = F.sub(z_rc, rc_dev[0::RANGE_CHECK_STEP])
    den_rc = F.sub(z_rc, rc_dev[RC_ORDERED::RANGE_CHECK_STEP])

    # diluted permutation over every row
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
    # a + b of the composed map, applied to acc0 = 1
    device = dil_ord.device
    u = F.sub(dil_ord[1:], dil_ord[:-1])
    a_seq = F.add(F.ones(u.shape[:-1], device), F.mul(z_da, u))
    b_seq = F.mul(a_da, F.mul(u, u))

    def compose(fst, snd):
        a1, b1 = fst
        a2, b2 = snd
        return F.mul(a1, a2), F.add(F.mul(b1, a2), b2)

    agg_a, agg_b = prefix_scan(compose, (a_seq, b_seq))
    agg = torch.cat([F.ones((1,), device), F.add(agg_a, agg_b)], dim=0)

    mem_rc = F.zeros((n,), device)
    mem_rc[0::MEMORY_STEP] = mem_cum
    mem_rc[1::RANGE_CHECK_STEP] = rc_cum
    return {7: agg, 8: dil_cum, 9: mem_rc}
