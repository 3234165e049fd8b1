"""Execution trace of the plain layout (port of
sandstorm_tpu/layouts/plain/trace.py).

The trace is built on the host with numpy, exactly as the JAX package builds
it: same virtual-column cell placement, range-check pool ordering and
padding, memory gap filling and ordered-memory construction.  The columns
are uploaded to the trace's device in one copy; the challenge-dependent
permutation column is built there from running products.
"""

import numpy as np
import torch

from ...binary.word import decode_words
from . import (CYCLE_HEIGHT, PUBLIC_MEMORY_STEP, MEMORY_STEP,
               RANGE_CHECK_STEP)
from .air import (
    NPC_PC, NPC_INSTRUCTION, NPC_PUBMEM_ADDR, NPC_PUBMEM_VAL,
    NPC_MEM_OP0_ADDR, NPC_MEM_OP0, NPC_MEM_DST_ADDR, NPC_MEM_DST,
    NPC_MEM_OP1_ADDR, NPC_MEM_OP1,
    RC_OFF_DST, RC_ORDERED, RC_AP, RC_OFF_OP1, RC_OP0_MUL_OP1, RC_OFF_OP0,
    RC_FP, RC_UNUSED, RC_RES, AUX_TMP0, AUX_TMP1,
    MEMORY_Z, MEMORY_A, RC_Z,
)
from ...fields.scan import prefix_mul


def _ints_to_u64limbs(vals):
    """list of python ints -> [n, 4] uint64 little-endian words."""
    out = np.zeros((len(vals), 4), dtype=np.uint64)
    for i, v in enumerate(vals):
        v = int(v)
        out[i, 0] = v & 0xFFFFFFFFFFFFFFFF
        out[i, 1] = (v >> 64) & 0xFFFFFFFFFFFFFFFF
        out[i, 2] = (v >> 128) & 0xFFFFFFFFFFFFFFFF
        out[i, 3] = (v >> 192) & 0xFFFFFFFFFFFFFFFF
    return out


class PlainExecutionTrace:
    """Built trace: canonical numpy columns + device field columns."""

    def __init__(self, F, program, air_public_input, witness, device):
        self.F = F
        self.device = torch.device(device)
        self.program = program
        self.public_input = air_public_input
        p = F.MODULUS

        registers = witness.register_states
        memory = witness.memory
        num_cycles = len(registers)
        assert num_cycles & (num_cycles - 1) == 0, \
            "number of cycles must be a power of two"
        n = num_cycles * CYCLE_HEIGHT
        self.trace_len = n

        dec = decode_words(registers, memory, p)

        # -- flags column (16 prefixes per cycle) --------------------------
        flags_col = np.zeros((n, 4), dtype=np.uint64)
        flags_col[:, 0] = dec.flag_prefixes.astype(np.uint64).reshape(-1)

        # -- npc column ----------------------------------------------------
        pad = air_public_input.public_memory_padding()
        pad_limbs = _ints_to_u64limbs([pad.value])[0]
        npc_col = np.zeros((n, 4), dtype=np.uint64)
        # default every [addr, val] pair to the padding entry
        npc_col[0::2, 0] = pad.address
        npc_col[1::2] = pad_limbs

        def set_cell(col, cell, arr):
            col[cell::CYCLE_HEIGHT] = arr

        def set_cell_small(col, cell, arr):
            col[cell::CYCLE_HEIGHT] = 0
            col[cell::CYCLE_HEIGHT, 0] = arr.astype(np.uint64)

        set_cell_small(npc_col, NPC_PC, registers.pc)
        set_cell(npc_col, NPC_INSTRUCTION, dec.instruction)
        set_cell_small(npc_col, NPC_MEM_OP0_ADDR, dec.op0_addr)
        set_cell(npc_col, NPC_MEM_OP0, memory.values[dec.op0_addr])
        set_cell_small(npc_col, NPC_MEM_DST_ADDR, dec.dst_addr)
        set_cell(npc_col, NPC_MEM_DST, memory.values[dec.dst_addr])
        set_cell_small(npc_col, NPC_MEM_OP1_ADDR, dec.op1_addr)
        set_cell(npc_col, NPC_MEM_OP1, memory.values[dec.op1_addr])
        # zero the public-memory pairs (cells 2,3 and 10,11 per cycle)
        for off in range(0, CYCLE_HEIGHT, PUBLIC_MEMORY_STEP):
            npc_col[off + NPC_PUBMEM_ADDR::CYCLE_HEIGHT] = 0
            npc_col[off + NPC_PUBMEM_VAL::CYCLE_HEIGHT] = 0

        # memory gap fill (plain/trace.rs:92-99): unknown addresses (skipping
        # address 0) are written as (addr, 0) into gap slots — pair index
        # 7 mod 8, i.e. cells (14, 15) of each cycle
        missing = np.nonzero(~memory.known[1:])[0] + 1
        assert len(missing) <= num_cycles, "too many memory gaps for trace"
        gap_rows = 14 + CYCLE_HEIGHT * np.arange(len(missing))
        npc_col[gap_rows] = 0
        npc_col[gap_rows, 0] = missing.astype(np.uint64)
        npc_col[gap_rows + 1] = 0

        # -- range-check column --------------------------------------------
        pool = np.concatenate([dec.off_dst, dec.off_op0, dec.off_op1])
        rc_sorted = np.sort(pool.astype(np.uint32))
        rc_min, rc_max = int(rc_sorted[0]), int(rc_sorted[-1])
        assert rc_min == air_public_input.rc_min, \
            (rc_min, air_public_input.rc_min)
        assert rc_max == air_public_input.rc_max
        diffs = np.diff(rc_sorted)
        gap_at = np.nonzero(diffs > 1)[0]
        padding_vals = (np.concatenate(
            [np.arange(rc_sorted[i] + 1, rc_sorted[i + 1]) for i in gap_at])
            if len(gap_at) else np.array([], dtype=np.uint32))
        assert len(padding_vals) <= num_cycles, "too much rc padding"
        ordered = np.sort(np.concatenate([rc_sorted, padding_vals]))
        num_ordered_slots = 4 * num_cycles
        assert len(ordered) <= num_ordered_slots

        rc_col = np.zeros((n, 4), dtype=np.uint64)
        rc_col[:, 0] = rc_max  # default = padding value (trace.rs:113-117)
        set_cell_small(rc_col, RC_OFF_DST, dec.off_dst)
        set_cell_small(rc_col, RC_AP, registers.ap)
        set_cell_small(rc_col, RC_OFF_OP1, dec.off_op1)
        set_cell(rc_col, RC_OP0_MUL_OP1, _ints_to_u64limbs(dec.op0_mul_op1))
        set_cell_small(rc_col, RC_OFF_OP0, dec.off_op0)
        set_cell_small(rc_col, RC_FP, registers.fp)
        set_cell(rc_col, RC_RES, _ints_to_u64limbs(dec.res))
        ordered_full = np.full(num_ordered_slots, rc_max, dtype=np.uint64)
        ordered_full[: len(ordered)] = ordered
        rc_col[RC_ORDERED::RANGE_CHECK_STEP] = 0
        rc_col[RC_ORDERED::RANGE_CHECK_STEP, 0] = ordered_full
        unused_fill = np.full(num_cycles, rc_max, dtype=np.uint64)
        unused_fill[: len(padding_vals)] = padding_vals
        rc_col[RC_UNUSED::CYCLE_HEIGHT] = 0
        rc_col[RC_UNUSED::CYCLE_HEIGHT, 0] = unused_fill

        # -- auxiliary column ----------------------------------------------
        aux_col = np.zeros((n, 4), dtype=np.uint64)
        set_cell(aux_col, AUX_TMP0, _ints_to_u64limbs(dec.tmp0))
        set_cell(aux_col, AUX_TMP1, _ints_to_u64limbs(dec.tmp1))

        # -- memory column: ordered accesses (layouts/src/utils.rs:116-154) -
        acc_addr = npc_col[0::2, 0].copy()           # [8*num_cycles]
        acc_val = npc_col[1::2].copy()
        pub = air_public_input.public_memory
        num_pub_cells = n // PUBLIC_MEMORY_STEP
        n_extra_pad = num_pub_cells - len(pub)
        assert n_extra_pad >= 0, "public memory larger than allotted cells"
        pad_addrs = np.full(n_extra_pad, pad.address, dtype=np.uint64)
        pad_vals = np.broadcast_to(pad_limbs, (n_extra_pad, 4))
        pub_addrs = np.array([e.address for e in pub], dtype=np.uint64)
        pub_vals = _ints_to_u64limbs([e.value for e in pub])
        all_addr = np.concatenate([acc_addr, pad_addrs, pub_addrs])
        all_val = np.concatenate([acc_val, pad_vals, pub_vals])
        order = np.argsort(all_addr, kind="stable")
        all_addr = all_addr[order]
        all_val = all_val[order]
        # first num_pub_cells entries are the address-0 "zeros" (paper §9.8)
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
            0: flags_col, 1: npc_col, 2: mem_col, 3: rc_col, 4: aux_col,
        }
        self._device_cols = None
        self.initial_registers = registers.arr[0]
        self.final_registers = registers.arr[-1]

    # -- device views ------------------------------------------------------

    def base_columns(self):
        """dict col -> [n, L] field tensors on the trace's device."""
        if self._device_cols is None:
            from ..utils import upload_base_columns
            self._device_cols = upload_base_columns(
                self.F, self.base_cols_canonical, self.device)
        return self._device_cols

    def build_extension_columns(self, challenges):
        """Permutation column from challenges (python ints): running
        products of the memory and range-check ratios, with one batch
        inversion each.  Returns {5: [n, L] tensor}."""
        F = self.F
        cols = self.base_columns()
        z = F.encode_int(challenges[MEMORY_Z], self.device)
        alpha = F.encode_int(challenges[MEMORY_A], self.device)
        z_rc = F.encode_int(challenges[RC_Z], self.device)
        return {5: _build_permutation_column(F, cols[1], cols[2], cols[3],
                                             z, alpha, z_rc)}


def _build_permutation_column(F, npc_dev, mem_dev, rc_dev, z, alpha, z_rc):
    n = npc_dev.shape[0]
    # memory permutation: ratio_k = (z - (a_k + alpha v_k)) / (z - (a'_k + alpha v'_k))
    a, v = npc_dev[0::2], npc_dev[1::2]
    ap_, vp = mem_dev[0::2], mem_dev[1::2]
    num = F.sub(z, F.add(a, F.mul(alpha, v)))
    den = F.sub(z, F.add(ap_, F.mul(alpha, vp)))
    mem_cum = prefix_mul(F, F.mul(num, F.batch_inv(den, 0)))

    # range-check permutation: ratio_k = (z - unordered_k) / (z - ordered_k)
    unordered = rc_dev[0::RANGE_CHECK_STEP]
    ordered = rc_dev[RC_ORDERED::RANGE_CHECK_STEP]
    num_rc = F.sub(z_rc, unordered)
    den_rc = F.sub(z_rc, ordered)
    rc_cum = prefix_mul(F, F.mul(num_rc, F.batch_inv(den_rc, 0)))

    perm = F.zeros((n,), npc_dev.device)
    perm[0::MEMORY_STEP] = mem_cum
    perm[1::RANGE_CHECK_STEP] = rc_cum
    return perm
