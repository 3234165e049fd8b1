"""The ALU probe's plain twin (sandstorm_tpu_torch/tools/probe_alu.py, the
port of tools/probe_alu.py) against numpy chains of the same six ops, on
the CPU: u32 ops exactly (numpy uint32 wraps), f32 ops within F32_RTOL of a
float64 chain (torch rounds o * b + o twice per step, the kernel's fma
once)."""

import numpy as np
import pytest
import torch

from sandstorm_tpu_torch import _native
from sandstorm_tpu_torch.tools import probe_alu as pa

U32_STEP = {
    "u32 mul": lambda o, b: o * b,
    "u32 add": lambda o, b: o + b,
    "u32 mul+add": lambda o, b: o * b + o,
    "u32 shift+and": lambda o, b: (o >> np.uint32(7)) & b,
}


@pytest.mark.parametrize("op", pa.OPS)
def test_plain_chain_matches_numpy(op):
    a, b = pa.inputs(op, "cpu", n=2048, seed=3)
    got = pa.probe_alu(a, b, op)          # a CPU tensor: the plain twin
    assert got.shape == a.shape and got.dtype == a.dtype
    if op.startswith("f32"):
        o, y = a.numpy().astype(np.float64), b.numpy().astype(np.float64)
        for _ in range(pa.R):
            o = o * y if op == "f32 mul" else o * y + o
        g = got.numpy().astype(np.float64)
        assert np.isfinite(g).all()
        assert np.max(np.abs(g - o) / np.abs(o)) < pa.F32_RTOL
    else:
        o, y = a.numpy().view(np.uint32), b.numpy().view(np.uint32)
        with np.errstate(over="ignore"):
            for _ in range(pa.R):
                o = U32_STEP[op](o, y)
        assert np.array_equal(got.numpy().view(np.uint32), o)


def test_probe_rejects_bad_inputs_and_cuda_only_launches():
    a, b = pa.inputs("u32 mul", "cpu", n=64)
    with pytest.raises(ValueError):
        pa.probe_alu(a, b, "u64 mul")
    with pytest.raises(ValueError):
        pa.probe_alu(a.float(), b.float(), "u32 mul")
    meta = torch.empty(64, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        pa.probe_alu(meta, meta, "u32 add")
    assert _native._lib is None and not _native.LAUNCHES.get("probe_alu")
