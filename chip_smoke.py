#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sandstorm_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, one JSON object per line:
  1. device and toolchain (torch, CUDA, nvcc, nvidia-smi, triton);
  2. the nvcc build of csrc/*.cu, with its time and registers per kernel;
  3. every kernel against its plain PyTorch twin on the card, bit-exact
     (tolerance 0: field arithmetic, transforms, openings and hashes are
     exact), with the kernel's time beside the plain version's;
  3e. the Pedersen walk (ec_madd_walk) against its plain version at the
     main path's largest level and at 8-bit windows, hash_pairs against the
     host C++ batch and the python oracle, one tree level of 2^5..2^12
     pairs timed on the card and on the host, and the 16-bit table build;
  4. the tiny plain/generic proof on the card, which must equal
     tests/data/self_proof_generic.bin byte for byte; 4b. the same claim
     under the cairo scheme, which must equal self_proof_cairo.bin;
  5. the slice at size: a 2^16-step plain-layout run proved under the
     generic scheme with the default ProofOptions (trace 2^20 rows, LDE
     2^21), twice, accepted by the port's verifier and rejected with one
     byte flipped; every kernel's launch count in the first prove must be
     > 0;
  6. the same claim under the cairo scheme (friendly Merkle trees, Pedersen
     levels through ec_madd_walk), twice, verified at 80 bits and rejected
     tampered; ec_madd_walk and every kernel of phase 5 must have launched;
  3f. the Goldilocks kernels (gl_mul/add/sub, gl3_mul) against their plain
     twins at 2^21 elements and in the broadcast forms the prover passes;
  3g. gl_ntt_leaf at plain-gl3-2^16's first forward-LDE leaf shape
     [2048, 3 x 5 x 1024, 2], GL and GL3 transforms at 2^12 and 2^21
     against the plain radix-2;
  3h. the ALU probe (tools/probe_alu.py), run through its entry point:
     every op against its plain chain, Tops/s per op;
  4c. the tiny Goldilocks and GF(p^3) proofs on the card, whose sha256
     must equal TINY_SHA256 (the JAX package's proofs of the same claims);
  7. the slice in GF(p^3) (plain-gl3-2^16): the claim of phase 5 with
     Goldilocks trace values and GF(p^3) challenges, twice, verified at 80
     bits and rejected tampered; every Goldilocks kernel and blake2s_rows
     must have launched, and no Fp252 kernel.
Then the nvidia-smi line, the kernels table {"kernels": [...]}, and last
{"ok": true, "device": {...}}.  Each kernel's `launches` is its count in
the run of the path named by its `path` (a slice's first prove, or the
probe tool's run).  Any failure raises before the last line.
Without a CUDA device, or without the repository around it, the script
exits non-zero and prints no result.
"""

import hashlib
import json
import os
import random
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
STEPS = 1 << 16
# sha256 of the JAX package's proofs of the tiny claim (16 steps,
# ProofOptions(num_queries=4, proof_of_work_bits=4), generic scheme) over
# Goldilocks and with GF(p^3) challenges: tests/test_torch_gl_slice.py
# holds the port's CPU proofs to them and compares with a live JAX prove
TINY_SHA256 = {
    "goldilocks":
        "ec1784946847a2a82e0618f930748a39b8c328aa7d1e7f46c850994867a869a2",
    "gl3":
        "c5e6371ad984c35655849e4307ba578c4c58bd80fef54dc921cdaac26a64185f",
}

# kernel entry -> (source, TPU kernel it replaces)
KERNELS = {
    "fp252_mul": ("sandstorm_tpu_torch/csrc/fp252.cu",
                  "sandstorm_tpu/fields/fp252_pallas.py:239"),
    "fp252_add": ("sandstorm_tpu_torch/csrc/fp252.cu",
                  "sandstorm_tpu/fields/fp252_pallas.py:97"),
    "fp252_sub": ("sandstorm_tpu_torch/csrc/fp252.cu",
                  "sandstorm_tpu/fields/fp252_pallas.py:110"),
    "ntt_leaf": ("sandstorm_tpu_torch/csrc/ntt.cu",
                 "sandstorm_tpu/ntt/ntt_pallas.py:101"),
    "open_pairs_partial": ("sandstorm_tpu_torch/csrc/open_pairs.cu",
                           "sandstorm_tpu/fields/fp252_pallas.py:336"),
    "open_pairs_reduce": ("sandstorm_tpu_torch/csrc/open_pairs.cu",
                          "sandstorm_tpu/fields/fp252_pallas.py:336"),
    "blake2s_rows": ("sandstorm_tpu_torch/csrc/blake2s.cu",
                     "sandstorm_tpu/hashing/blake2s.py:95"),
    "ec_madd_walk": ("sandstorm_tpu_torch/csrc/ec_madd.cu",
                     "sandstorm_tpu/fields/fp252_pallas.py:181"),
    "gl_mul": ("sandstorm_tpu_torch/csrc/goldilocks.cu",
               "sandstorm_tpu/fields/gl_pallas.py:29"),
    "gl_add": ("sandstorm_tpu_torch/csrc/goldilocks.cu",
               "sandstorm_tpu/fields/gl_pallas.py:40"),
    "gl_sub": ("sandstorm_tpu_torch/csrc/goldilocks.cu",
               "sandstorm_tpu/fields/gl_pallas.py:47"),
    "gl3_mul": ("sandstorm_tpu_torch/csrc/goldilocks.cu",
                "sandstorm_tpu/fields/gl3.py:284"),
    "gl_ntt_leaf": ("sandstorm_tpu_torch/csrc/gl_ntt.cu",
                    "sandstorm_tpu/ntt/ntt_pallas.py:101"),
    "probe_alu": ("sandstorm_tpu_torch/csrc/probe_alu.cu",
                  "tools/probe_alu.py:31"),
}
# the kernels of each path: the generic scheme's (phase 5), the cairo
# scheme's (phase 6), the GF(p^3) slice's (phase 7) and the probe tool's
FP252_KERNELS = ["fp252_mul", "fp252_add", "fp252_sub", "ntt_leaf",
                 "open_pairs_partial", "open_pairs_reduce"]
GENERIC_KERNELS = FP252_KERNELS + ["blake2s_rows"]
CAIRO_KERNELS = GENERIC_KERNELS + ["ec_madd_walk"]
GL3_KERNELS = ["gl_mul", "gl_add", "gl_sub", "gl3_mul", "gl_ntt_leaf",
               "blake2s_rows"]
PATHS = {"slice_cairo": CAIRO_KERNELS, "slice_gl3": GL3_KERNELS,
         "probe_alu": ["probe_alu"]}


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def run_cmd(args):
    proc = subprocess.run(args, capture_output=True, text=True, timeout=120)
    check(proc.returncode == 0, f"{args[0]} failed: {proc.stderr[-500:]}")
    return proc.stdout.strip()


def cuda_ms(torch, fn, iters):
    """Mean milliseconds of fn() over `iters` back-to-back calls, by CUDA
    events after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_once(torch, fn):
    """(fn(), milliseconds of that one call by CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def max_abs_err(torch, a, b):
    """Largest |difference| of the u32 words of two limb tensors."""
    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    da = a.to(torch.int64) & 0xFFFFFFFF
    db = b.to(torch.int64) & 0xFFFFFFFF
    return int((da - db).abs().max().item()) if a.numel() else 0


def ptxas_report(log):
    """({kernel: registers}, {kernel: [spill store bytes, spill load
    bytes]}) from nvcc's -Xptxas -v report."""
    names = [("blake2s_kernel", "blake2s_rows"),
             ("12binop_kernelILi0", "fp252_add"),
             ("12binop_kernelILi1", "fp252_sub"),
             ("12binop_kernelILi2", "fp252_mul"),
             ("15ntt_leaf_kernel", "ntt_leaf"),
             ("15gl_binop_kernelILi0", "gl_add"),
             ("15gl_binop_kernelILi1", "gl_sub"),
             ("15gl_binop_kernelILi2", "gl_mul"),
             ("14gl3_mul_kernel", "gl3_mul"),
             ("18gl_ntt_leaf_kernel", "gl_ntt_leaf"),
             ("12probe_kernelILi2", "probe_alu"),
             ("open_pairs_partial_kernel", "open_pairs_partial"),
             ("open_pairs_reduce_kernel", "open_pairs_reduce"),
             ("walk_kernelILi16", "ec_madd_walk"),
             ("walk_kernelILi8", "ec_madd_walk_w8")]
    regs, spills, cur = {}, {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = next((n for key, n in names if key in line), None)
        elif "Used" in line and "registers" in line and cur:
            regs[cur] = int(line.split("Used")[1].split()[0])
        elif "spill stores" in line and cur:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            spills[cur] = nums[1:3]   # stack frame, stores, loads
    return regs, spills


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from sandstorm_tpu_torch import _native, _tables, native
    from sandstorm_tpu_torch.builtins.pedersen import pedersen_hash_oracle
    from sandstorm_tpu_torch.claims import loop_claim
    from sandstorm_tpu_torch.fields import fp252_cuda as fc
    from sandstorm_tpu_torch.fields import gl_cuda
    from sandstorm_tpu_torch.fields.fp252 import Fp252 as F
    from sandstorm_tpu_torch.fields.gl3 import GL3, Fq3S
    from sandstorm_tpu_torch.fields.goldilocks import GL
    from sandstorm_tpu_torch.hashing import blake2s
    from sandstorm_tpu_torch.hashing import pedersen
    from sandstorm_tpu_torch.layouts.plain.air import PlainAirConfig
    from sandstorm_tpu_torch.ntt import ntt
    from sandstorm_tpu_torch.ntt import ntt_cuda
    from sandstorm_tpu_torch.stark import prover
    from sandstorm_tpu_torch.stark.ark import parse_proof, serialize_proof
    from sandstorm_tpu_torch.stark.openings import point_powers
    from sandstorm_tpu_torch.stark.options import ProofOptions
    from sandstorm_tpu_torch.stark.verifier import VerificationError
    from sandstorm_tpu_torch.air.expr import trace_arguments
    from sandstorm_tpu_torch.tools import probe_alu

    dev = torch.device("cuda", 0)
    P = F.MODULUS
    rng = np.random.default_rng(2026)
    results = {}   # kernel entry -> {max_abs_err, ms, plain_ms, shape}

    # -- 1: device and toolchain -----------------------------------------
    smi = run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"])
    print(smi, flush=True)
    try:
        import triton
        triton_version = triton.__version__
    except ImportError as e:
        triton_version = f"not importable: {e}"
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "python": sys.version.split()[0], "torch": torch.__version__,
          "torch_cuda": torch.version.cuda,
          "nvcc": run_cmd([_native.nvcc_path(),
                           "--version"]).splitlines()[-1],
          "triton": triton_version})

    # -- 2: kernel build ---------------------------------------------------
    t0 = time.perf_counter()
    info = _native.build()
    _native.lib()
    emit({"phase": "build", "built": info["built"],
          "nvcc_s": info["seconds"], "total_s": time.perf_counter() - t0,
          "library": os.path.relpath(info["path"], ROOT),
          **dict(zip(("registers", "spill_bytes"),
                     ptxas_report(info["log"])))})

    def rand_elems(n):
        """n random field elements (< 2^251) led by 0, 1 and p - 1 in raw
        and in Montgomery form."""
        w = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
        w[:, 7] &= (1 << 27) - 1
        x = torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev)
        special = F.encode_ints([0, 1, P - 1], dev)
        raw = torch.from_numpy(np.array(
            [[(v >> (32 * k)) & 0xFFFFFFFF for k in range(8)]
             for v in (0, 1, P - 1)], dtype=np.uint32).view(np.int32)).to(dev)
        x[:3] = special
        x[3:6] = raw
        return x

    # -- 3a: kernel 1, elementwise multiply / add / subtract ----------------
    n = 1 << 20
    a, b = rand_elems(n), rand_elems(n).flip(0).contiguous()
    want_host = {"add": lambda x, y: (x + y) % P,
                 "sub": lambda x, y: (x - y) % P,
                 "mul": lambda x, y: x * y % P}
    for op in ("mul", "add", "sub"):
        got = fc.binop(op, a, b)
        err = max_abs_err(torch, got, fc.PLAIN[op](a, b))
        check(err == 0, f"fp252_{op} differs from its plain version")
        xs, ys, zs = (F.decode_ints(t[:512]) for t in (a, b, got))
        check(zs == [want_host[op](x, y) for x, y in zip(xs, ys)],
              f"fp252_{op} differs from python ints")
        results[f"fp252_{op}"] = {
            "max_abs_err": err, "shape": [n, 8],
            "ms": cuda_ms(torch, lambda: fc.binop(op, a, b), 20),
            "plain_ms": cuda_ms(torch, lambda: fc.PLAIN[op](a, b), 3)}
    # the broadcast operands the prover passes, read in place: a scalar, a
    # tiled period, a repeated table
    a4 = rand_elems(4 * 6 * 5).reshape(4, 6, 5, 8)
    t = rand_elems(24)
    for b4 in (t[0], t.reshape(4, 6, 1, 8), t[:1].reshape(1, 1, 1, 8),
               t[:6].reshape(6, 1, 8), t[:5].reshape(5, 8)):
        shape = list(b4.shape)
        check(max_abs_err(torch, F.mul(a4, b4), fc.mul_plain(a4, b4)) == 0,
              f"fp252_mul with a {shape} operand differs")
        check(max_abs_err(torch, F.sub(b4, a4), fc.sub_plain(b4, a4)) == 0,
              f"fp252_sub with a {shape} operand differs")
    emit({"phase": "kernel_fp252", "n": n, "broadcast_forms_equal": True,
          **{k: v for k, v in results.items() if k.startswith("fp252")}})

    # -- 3b: kernel 2, the NTT leaf ----------------------------------------
    ntt_checks = {}
    for logn in (12, 21):
        N = 1 << logn
        x = rand_elems(N)
        for inverse in (False, True):
            got = ntt(F, x, inverse=inverse)
            t0 = time.perf_counter()
            want = ntt_cuda.ntt_leaf_plain(
                x[:, None], ntt_cuda.stage_table(F, N, inverse, dev))[:, 0]
            if inverse:
                want = fc.mul_plain(want, F.encode_int(pow(N, -1, P), dev))
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            err = max_abs_err(torch, got, want)
            check(err == 0, f"ntt 2^{logn} inverse={inverse} differs")
            ntt_checks[f"2^{logn}{'_inv' if inverse else ''}"] = {
                "max_abs_err": err,
                "ms": cuda_ms(torch, lambda: ntt(F, x, inverse=inverse), 5),
                "plain_radix2_ms": plain_s * 1e3}
    # the leaf at the main path's first forward-LDE shape: 2^21 rows of 5
    # columns split as R = 2048 rows by (1024 x 5) transforms
    x = rand_elems(2048 * 5120).reshape(2048, 5120, 8)
    tw = ntt_cuda.stage_table(F, 2048, False, dev)
    err = max_abs_err(torch, ntt_cuda.ntt_leaf(x, tw),
                      ntt_cuda.ntt_leaf_plain(x, tw))
    check(err == 0, "ntt_leaf differs from its plain version")
    results["ntt_leaf"] = {
        "max_abs_err": err, "shape": [2048, 5120, 8],
        "ms": cuda_ms(torch, lambda: ntt_cuda.ntt_leaf(x, tw), 10),
        "plain_ms": cuda_ms(torch, lambda: ntt_cuda.ntt_leaf_plain(x, tw),
                            1)}
    del x
    emit({"phase": "kernel_ntt", "transforms": ntt_checks,
          "leaf": results["ntt_leaf"]})

    # -- 3c: kernel 3, the pair-indexed opener at the main path's shape -----
    n = 1 << 20
    g = F.root_of_unity_int(n)
    targs = trace_arguments(PlainAirConfig.constraints(n, P, g))
    ncols = PlainAirConfig.NUM_BASE_COLUMNS \
        + PlainAirConfig.NUM_EXTENSION_COLUMNS
    offsets = sorted({off for (_, off) in targs})
    pairs = sorted({(offsets.index(off), c) for (c, off) in targs})
    pairs += [(len(offsets), ncols + l) for l in range(2)]  # composition at z^2
    cols = rand_elems((ncols + 2) * n).reshape(ncols + 2, n, 8)
    prng = random.Random(7)
    pts = [prng.randrange(P) for _ in range(len(offsets) + 1)]
    bb = 1 << ((n.bit_length() - 1) // 2)
    lo = point_powers(F, pts, bb, dev)
    hi = point_powers(F, [pow(pt, bb, P) for pt in pts], n // bb, dev)
    kidx = torch.tensor([k for k, _ in pairs], dtype=torch.int32, device=dev)
    cidx = torch.tensor([c for _, c in pairs], dtype=torch.int32, device=dev)
    got = fc.open_pairs(cols, lo, hi, kidx, cidx)
    t0 = time.perf_counter()
    want = fc.open_pairs_plain(cols, lo, hi, kidx.tolist(), cidx.tolist())
    torch.cuda.synchronize()
    plain_open_ms = (time.perf_counter() - t0) * 1e3
    err = max_abs_err(torch, got, want)
    check(err == 0, "open_pairs differs from its plain version")
    # the two launches timed apart; the reduce is checked on its own input
    nchunks = -(-n // fc.OPEN_CHUNK)
    partial = torch.empty((len(pairs), nchunks, 8), dtype=torch.int32,
                          device=dev)
    out = torch.empty((len(pairs), 8), dtype=torch.int32, device=dev)

    def partial_launch():
        _native.launch("open_pairs_partial", dev, cols.data_ptr(), n,
                       lo.data_ptr(), bb.bit_length() - 1, hi.data_ptr(),
                       kidx.data_ptr(), cidx.data_ptr(), len(pairs), nchunks,
                       fc.OPEN_CHUNK, partial.data_ptr())

    def reduce_launch():
        _native.launch("open_pairs_reduce", dev, partial.data_ptr(),
                       len(pairs), nchunks, out.data_ptr())

    partial_ms = cuda_ms(torch, partial_launch, 5)
    reduce_ms = cuda_ms(torch, reduce_launch, 20)

    def reduce_plain():
        return torch.stack([fc.tree_sum_plain(partial[q])
                            for q in range(len(pairs))])

    reduce_err = max_abs_err(torch, out, reduce_plain())
    check(reduce_err == 0, "open_pairs_reduce differs from its plain version")
    results["open_pairs_partial"] = {
        "max_abs_err": err, "shape": [len(pairs), ncols + 2, n, 8],
        "ms": partial_ms, "plain_ms": plain_open_ms}
    results["open_pairs_reduce"] = {
        "max_abs_err": reduce_err, "shape": [len(pairs), nchunks, 8],
        "ms": reduce_ms, "plain_ms": cuda_ms(torch, reduce_plain, 1)}
    emit({"phase": "kernel_open_pairs", "pairs": len(pairs),
          "points": len(pts), "n": n,
          "opener_ms": cuda_ms(
              torch, lambda: fc.open_pairs(cols, lo, hi, kidx, cidx), 5),
          "partial": results["open_pairs_partial"],
          "reduce": results["open_pairs_reduce"]})
    del cols, partial

    # -- 3d: kernel 4, Blake2s ------------------------------------------------
    for W, label in ((40, "rows"), (16, "node_pairs")):
        msg = torch.from_numpy(rng.integers(
            0, 1 << 32, size=(1 << 16, W), dtype=np.uint64).astype(
            np.uint32).view(np.int32)).to(dev)
        got = blake2s.blake2s_words(msg)
        err = max_abs_err(torch, got, blake2s.blake2s_words_plain(msg, 4 * W))
        check(err == 0, f"blake2s {label} differs from its plain version")
        host_msg = msg[:64].cpu().numpy().view(np.uint32)
        host_dig = got[:64].cpu().numpy().view(np.uint32)
        for r in range(64):
            check(host_dig[r].astype("<u4").tobytes() == hashlib.blake2s(
                host_msg[r].astype("<u4").tobytes(), digest_size=32).digest(),
                f"blake2s {label} row {r} differs from hashlib")
        entry = {"max_abs_err": err, "shape": [1 << 16, W],
                 "ms": cuda_ms(torch, lambda: blake2s.blake2s_words(msg), 20),
                 "plain_ms": cuda_ms(
                     torch, lambda: blake2s.blake2s_words_plain(msg, 4 * W),
                     2)}
        if W == 40:
            results["blake2s_rows"] = entry
        emit({"phase": f"kernel_blake2s_{label}", **entry})
    # byte lengths that end inside a word, and the empty message
    for W, nbytes in ((3, 9), (1, 0)):
        msg = torch.from_numpy(rng.integers(
            0, 1 << 32, size=(300, W), dtype=np.uint64).astype(
            np.uint32).view(np.int32)).to(dev)
        got = blake2s.blake2s_words(msg, nbytes)
        check(max_abs_err(torch, got,
                          blake2s.blake2s_words_plain(msg, nbytes)) == 0,
              f"blake2s of {nbytes} bytes differs from its plain version")
        host_msg = msg.cpu().numpy().view(np.uint32)
        host_dig = got.cpu().numpy().view(np.uint32)
        for r in range(0, 300, 37):
            check(host_dig[r].astype("<u4").tobytes() == hashlib.blake2s(
                host_msg[r].astype("<u4").tobytes()[:nbytes],
                digest_size=32).digest(),
                f"blake2s of {nbytes} bytes, row {r}, differs from hashlib")
    emit({"phase": "kernel_blake2s_short", "byte_lengths": [9, 0],
          "equal": True})

    # -- 3e: kernel 5, the Pedersen walk -------------------------------------
    # the 8-bit window tables, built in python on the host once per process
    # (the host C++ batch and the 8-bit walk read them), then the 16-bit
    # table on its own: combined from them on the card through the montmul
    # kernel, once per device
    t0 = time.perf_counter()
    native._window_tables()
    tables8_host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t16 = pedersen.tables16(F, dev)
    torch.cuda.synchronize()
    table16_s = time.perf_counter() - t0
    t8, shift = pedersen.tables8(dev), pedersen.shift_point(dev)
    walk = {}
    # 2^20 pairs: the first Pedersen level of a 2^21-leaf tree, the main
    # path's largest
    for bits, M in ((16, 1 << 20), (8, 1 << 12)):
        table = t16 if bits == 16 else t8
        a, b = rand_elems(M), rand_elems(M).flip(0).contiguous()
        got = fc.ec_madd_walk(a, b, table, shift, bits)
        want, plain_ms = cuda_ms_once(
            torch, lambda: fc.ec_madd_walk_plain(a, b, table, shift, bits))
        err = max(max_abs_err(torch, g, w) for g, w in zip(got, want))
        check(err == 0, f"ec_madd_walk ({bits}-bit) differs from its plain "
                        f"version at M = {M}")
        walk[bits] = {"max_abs_err": err, "shape": [M, 8], "M": M,
                      "ms": cuda_ms(torch, lambda: fc.ec_madd_walk(
                          a, b, table, shift, bits), 5),
                      "plain_ms": plain_ms}
    results["ec_madd_walk"] = walk[16]
    del a, b, got, want
    # hash_pairs against the host C++ batch (all) and the python oracle
    # (a few), with zero inputs, a high window and masked-digest sizes
    prng = random.Random(11)
    av = [0, 5, prng.getrandbits(160), 0, P - 1] + [
        prng.getrandbits(251) for _ in range(1019)]
    bv = [0, 0, prng.getrandbits(160), (1 << 248) + 5, P - 1] + [
        prng.getrandbits(160 if i % 2 else 251) for i in range(1019)]

    def canon(vals):
        return torch.from_numpy(np.stack(
            [native._int_to_limbs(v) for v in vals]).view(np.int32)).to(dev)

    ca, cb = canon(av), canon(bv)
    hp = pedersen.hash_pairs(F, ca, cb)
    host = native.pedersen_hash_pairs(ca.cpu().numpy().view("<u8"),
                                      cb.cpu().numpy().view("<u8"))
    check(np.array_equal(hp.cpu().numpy().view("<u8"), host),
          "hash_pairs differs from the host C++ batch")
    got_ints = [int.from_bytes(r.tobytes(), "little") for r in host[:8]]
    check(got_ints == [pedersen_hash_oracle(x, y)
                       for x, y in zip(av[:8], bv[:8])],
          "hash_pairs differs from the python oracle")
    # one friendly-tree level of M pairs on each route, host clock (median
    # of 5): hash_pairs on the card (it syncs for the inversion) against the
    # host C++ batch on inputs already on the host; merkle.py sends levels
    # of at least DEVICE_PEDERSEN_MIN_PAIRS pairs to the card
    crossover = {}
    for logm in range(5, 13):
        M = 1 << logm
        da, db = rand_elems(M), rand_elems(M).flip(0).contiguous()
        ha, hb = (t.cpu().numpy().view("<u8") for t in (da, db))
        check(np.array_equal(pedersen.hash_pairs(F, da, db).cpu().numpy()
                             .view("<u8"), native.pedersen_hash_pairs(ha, hb)),
              f"hash_pairs differs from the host batch at M = {M}")
        dev_s, host_s = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pedersen.hash_pairs(F, da, db)
            torch.cuda.synchronize()
            dev_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            native.pedersen_hash_pairs(ha, hb)
            host_s.append(time.perf_counter() - t0)
        crossover[M] = {"device_ms": sorted(dev_s)[2] * 1e3,
                        "host_ms": sorted(host_s)[2] * 1e3}
    emit({"phase": "kernel_ec_madd_walk",
          "walk_16bit": walk[16], "walk_8bit": walk[8],
          "tables8_host_s": tables8_host_s,
          "table16_build_s": table16_s, "table16_bytes":
          t16.numel() * t16.element_size(),
          "hash_pairs_vs_host": len(av), "hash_pairs_vs_oracle": 8,
          "hash_pairs_ms": cuda_ms(
              torch, lambda: pedersen.hash_pairs(F, ca, cb), 5),
          "level_device_vs_host": crossover,
          "device_faster_from_pairs": min(
              [M for M, r in crossover.items()
               if r["device_ms"] < r["host_ms"]], default=None)})
    del t16

    # -- 3f: the Goldilocks kernels -----------------------------------------
    PG = GL.MODULUS

    def rand_gl(n, width):
        """n random canonical elements of `width` words (2: GL, 6: GL3),
        every hi word below 2^32 - 1, led by 0, 1, p - 1, 2^32 - 1, 2^32
        and 2^63 in every coordinate."""
        w = rng.integers(0, 1 << 32, size=(n, width), dtype=np.uint64)
        w[:, 1::2] %= 0xFFFFFFFF
        x = torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev)
        edges = [0, 1, PG - 1, (1 << 32) - 1, 1 << 32, 1 << 63]
        x[:len(edges)] = GL.encode_ints(edges, dev).repeat(1, width // 2)
        return x

    n = 1 << 21
    gl_host = {"add": lambda x, y: (x + y) % PG,
               "sub": lambda x, y: (x - y) % PG,
               "mul": lambda x, y: x * y % PG}
    a, b = rand_gl(n, 2), rand_gl(n, 2).flip(0).contiguous()
    for op in ("mul", "add", "sub"):
        got = gl_cuda.binop(op, a, b)
        err = max_abs_err(torch, got, gl_cuda.PLAIN[op](a, b))
        check(err == 0, f"gl_{op} differs from its plain version")
        xs, ys, zs = (GL.decode_ints(t[:512]) for t in (a, b, got))
        check(zs == [gl_host[op](x, y) for x, y in zip(xs, ys)],
              f"gl_{op} differs from python ints")
        results[f"gl_{op}"] = {
            "max_abs_err": err, "shape": [n, 2],
            "ms": cuda_ms(torch, lambda: gl_cuda.binop(op, a, b), 20),
            "plain_ms": cuda_ms(torch, lambda: gl_cuda.PLAIN[op](a, b), 3)}
    a, b = rand_gl(n, 6), rand_gl(n, 6).flip(0).contiguous()
    got = gl_cuda.gl3_mul(a, b)
    err = max_abs_err(torch, got, gl_cuda.gl3_mul_plain(a, b))
    check(err == 0, "gl3_mul differs from its plain version")
    xs, ys, zs = (GL3.decode_ints(t[:256]) for t in (a, b, got))
    check(zs == [int(Fq3S.from_packed(x) * Fq3S.from_packed(y))
                 for x, y in zip(xs, ys)], "gl3_mul differs from Fq3S")
    results["gl3_mul"] = {
        "max_abs_err": err, "shape": [n, 6],
        "ms": cuda_ms(torch, lambda: gl_cuda.gl3_mul(a, b), 20),
        "plain_ms": cuda_ms(torch, lambda: gl_cuda.gl3_mul_plain(a, b), 3)}
    for op in ("add", "sub"):     # the GL kernels on the [..., 3, 2] view
        check(torch.equal(getattr(GL3, op)(a[:4096], b[:4096]).cpu(),
                          getattr(GL3, op)(a[:4096].cpu(), b[:4096].cpu())),
              f"GL3.{op} on the card differs from the CPU")
    # the broadcast operands the prover passes, read in place
    for width, mul, mul_plain in (
            (2, lambda x, y: gl_cuda.binop("mul", x, y), gl_cuda.mul_plain),
            (6, gl_cuda.gl3_mul, gl_cuda.gl3_mul_plain)):
        a4 = rand_gl(4 * 6 * 5, width).reshape(4, 6, 5, width)
        t = rand_gl(24, width)
        for b4 in (t[0], t.reshape(4, 6, 1, width),
                   t[:1].reshape(1, 1, 1, width), t[:6].reshape(6, 1, width),
                   t[:5].reshape(5, width)):
            shape = list(b4.shape)
            check(max_abs_err(torch, mul(a4, b4), mul_plain(a4, b4)) == 0,
                  f"{'gl3_mul' if width == 6 else 'gl_mul'} with a {shape} "
                  f"operand differs")
            if width == 2:
                check(max_abs_err(torch, gl_cuda.binop("sub", b4, a4),
                                  gl_cuda.sub_plain(b4, a4)) == 0,
                      f"gl_sub with a {shape} operand differs")
    emit({"phase": "kernel_gl", "n": n, "broadcast_forms_equal": True,
          **{k: results[k] for k in ("gl_mul", "gl_add", "gl_sub",
                                     "gl3_mul")}})
    del a, b, got

    # -- 3g: the Goldilocks NTT leaf ---------------------------------------
    gl_ntt = {}
    for logn in (12, 21):
        N = 1 << logn
        for Fg, width in ((GL, 2), (GL3, 6)):
            x = rand_gl(N, width)
            for inverse in (False, True):
                got = ntt(Fg, x, inverse=inverse)
                t0 = time.perf_counter()
                want = ntt_cuda.ntt_leaf_plain(
                    x.reshape(N, -1, 2),
                    ntt_cuda.stage_table(GL, N, inverse, dev),
                    gl_cuda.PLAIN).reshape(x.shape)
                if inverse:
                    scale = (gl_cuda.mul_plain if width == 2
                             else gl_cuda.gl3_mul_plain)
                    want = scale(want, Fg.encode_int(pow(N, -1, PG), dev))
                torch.cuda.synchronize()
                plain_s = time.perf_counter() - t0
                err = max_abs_err(torch, got, want)
                check(err == 0, f"{Fg.NAME} ntt 2^{logn} inverse={inverse} "
                                f"differs")
                gl_ntt[f"{Fg.NAME} 2^{logn}{'_inv' if inverse else ''}"] = {
                    "max_abs_err": err,
                    "ms": cuda_ms(torch, lambda: ntt(Fg, x, inverse=inverse),
                                  5),
                    "plain_radix2_ms": plain_s * 1e3}
    # the leaf at plain-gl3-2^16's first forward-LDE shape: 2^21 rows of 5
    # GF(p^3) columns (15 GL columns) split as R = 2048 rows by 1024 x 15
    # transforms
    x = rand_gl(2048 * 15360, 2).reshape(2048, 15360, 2)
    tw = ntt_cuda.stage_table(GL, 2048, False, dev)
    err = max_abs_err(torch, ntt_cuda.gl_ntt_leaf(x, tw),
                      ntt_cuda.ntt_leaf_plain(x, tw, gl_cuda.PLAIN))
    check(err == 0, "gl_ntt_leaf differs from its plain version")
    results["gl_ntt_leaf"] = {
        "max_abs_err": err, "shape": [2048, 15360, 2],
        "ms": cuda_ms(torch, lambda: ntt_cuda.gl_ntt_leaf(x, tw), 10),
        "plain_ms": cuda_ms(
            torch, lambda: ntt_cuda.ntt_leaf_plain(x, tw, gl_cuda.PLAIN), 1)}
    del x
    emit({"phase": "kernel_gl_ntt", "transforms": gl_ntt,
          "leaf": results["gl_ntt_leaf"]})

    # -- 3h: the ALU probe, through the tool's entry point ----------------
    _native.reset_counts()
    probe = {op: dict(zip(("ms", "tops_per_s"), probe_alu.run(op, dev)))
             for op in probe_alu.OPS}
    probe_launches = dict(_native.LAUNCHES)
    for op, entry in probe.items():
        a, b = probe_alu.inputs(op, dev)
        got = probe_alu.probe_alu(a, b, op)
        want = probe_alu.probe_alu_plain(a, b, op)
        if op.startswith("f32"):
            rel = float(((got.double() - want.double()).abs()
                         / want.double().abs()).max())
            check(rel <= probe_alu.F32_RTOL,
                  f"probe {op} differs from its plain chain ({rel})")
            entry["max_rel_err"] = rel
        else:
            entry["max_abs_err"] = max_abs_err(torch, got, want)
            check(entry["max_abs_err"] == 0,
                  f"probe {op} differs from its plain chain")
    # the kernel and its plain chain over the same full grid, one op
    op = "u32 mul+add"
    a, b = (t.repeat(probe_alu.COPIES) for t in probe_alu.inputs(op, dev))
    _, plain_ms = cuda_ms_once(
        torch, lambda: probe_alu.probe_alu_plain(a, b, op))
    del a, b
    results["probe_alu"] = {
        "max_abs_err": probe[op]["max_abs_err"], "op": op,
        "shape": [probe_alu.TILE * probe_alu.COPIES], "ms": probe[op]["ms"],
        "plain_ms": plain_ms}
    emit({"phase": "probe_alu", "nvidia_smi": smi, "r": probe_alu.R,
          "elements": probe_alu.TILE * probe_alu.COPIES, "ops": probe,
          "launches": probe_launches})

    # -- 4: the tiny proofs on the card -------------------------------------
    for scheme in ("generic", "cairo"):
        claim, witness = loop_claim(16, dev, scheme=scheme)
        t0 = time.perf_counter()
        blob = serialize_proof(claim.prove(
            witness, ProofOptions(num_queries=4, proof_of_work_bits=4)))
        tiny_s = time.perf_counter() - t0
        with open(os.path.join(ROOT, "tests", "data",
                               f"self_proof_{scheme}.bin"), "rb") as f:
            pinned = f.read()
        check(blob == pinned,
              f"tiny GPU proof ({scheme}) differs from the pinned bytes")
        emit({"phase": "tiny_proof", "scheme": scheme,
              "equal_to_pinned": True, "bytes": len(blob),
              "prove_s": tiny_s})

    # -- 4c: the tiny Goldilocks and GF(p^3) proofs ------------------------
    for name, Fg in (("goldilocks", GL), ("gl3", GL3)):
        claim, witness = loop_claim(16, dev, field=Fg)
        t0 = time.perf_counter()
        blob = serialize_proof(claim.prove(
            witness, ProofOptions(num_queries=4, proof_of_work_bits=4)))
        tiny_s = time.perf_counter() - t0
        check(hashlib.sha256(blob).hexdigest() == TINY_SHA256[name],
              f"tiny GPU proof ({name}) differs from the JAX package's")
        check(claim.verify(parse_proof(blob, modulus=Fg.MODULUS),
                           required_security_bits=0),
              f"port verifier rejected the tiny {name} proof")
        emit({"phase": "tiny_proof", "scheme": "generic", "field": name,
              "sha256_equal_to_jax": True, "bytes": len(blob),
              "prove_s": tiny_s})

    # -- 5 and 6: the slice at size, under each scheme ---------------------
    def run_slice(phase, scheme, kernels, field=F):
        t0 = time.perf_counter()
        claim, witness = loop_claim(STEPS, dev, scheme=scheme, field=field)
        witness_s = time.perf_counter() - t0
        options = ProofOptions()
        # drop the 16-bit Pedersen table that phases 3e and 4b left cached:
        # the cairo scheme's first prove builds it again, so that
        # first_prove_s carries it
        _tables.evict("pedersen_w16", dev)
        _native.reset_counts()
        native.HASHES.clear()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        proof = claim.prove(witness, options)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = dict(_native.LAUNCHES)
        hashes = dict(native.HASHES)
        phases_first = [[k, v] for k, v in prover.LAST_PHASES]
        peak_first = torch.cuda.max_memory_allocated(dev)
        missing = [k for k in kernels if launches.get(k, 0) == 0]
        check(not missing, f"{phase} path launched no {missing}")

        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        proof2 = claim.prove(witness, options)
        torch.cuda.synchronize()
        second_s = time.perf_counter() - t0
        peak_second = torch.cuda.max_memory_allocated(dev)
        blob = serialize_proof(proof)
        check(serialize_proof(proof2) == blob,
              f"two proves of one claim differ ({phase})")

        t0 = time.perf_counter()
        check(claim.verify(parse_proof(blob, modulus=field.MODULUS),
                           required_security_bits=80),
              f"port verifier rejected the proof ({phase})")
        verify_s = time.perf_counter() - t0
        bad = bytearray(blob)
        bad[len(bad) // 2] ^= 0x01
        try:
            claim.verify(parse_proof(bytes(bad), modulus=field.MODULUS))
            rejected = False
        except (VerificationError, AssertionError):
            rejected = True
        check(rejected, f"port verifier accepted a proof with one byte "
                        f"flipped ({phase})")
        line = {"phase": phase, "scheme": scheme, "field": field.NAME,
                "steps": STEPS,
                "trace_rows": proof.trace_len,
                "lde_rows": proof.trace_len * options.lde_blowup_factor,
                "options": list(proof.options), "witness_s": witness_s,
                "first_prove_s": first_s, "prove_s": second_s,
                "steps_per_s": STEPS / second_s,
                "phases_first": phases_first,
                "phases": [[k, v] for k, v in prover.LAST_PHASES],
                "peak_mem_bytes_first": peak_first,
                "peak_mem_bytes": peak_second, "proof_bytes": len(blob),
                "verify_s": verify_s, "verified_bits": 80,
                "tampered_rejected": rejected, "launches": launches}
        if scheme == "cairo":
            # Pedersen hashes of the first prove, by route: the kernel
            # ("cuda") and the host C++ batch ("host", the small tree levels
            # and the transcript's felt-list reseeds)
            line["pedersen_hashes"] = hashes
        if field is not F:
            # the GF(p^3) path runs no Fp252 kernel
            line["fp252_launches"] = sum(
                launches.get(k, 0) for k in FP252_KERNELS + ["ec_madd_walk"])
            check(line["fp252_launches"] == 0,
                  f"{phase} launched Fp252 kernels")
        emit(line)
        return launches

    run_slice("slice", "generic", GENERIC_KERNELS)
    path_launches = {
        "slice_cairo": run_slice("slice_cairo", "cairo", CAIRO_KERNELS),
        "slice_gl3": run_slice("slice_gl3", "generic", GL3_KERNELS, GL3),
        "probe_alu": probe_launches}

    print(smi, flush=True)
    rows = []
    for k, (src, rep) in KERNELS.items():
        path = next(p for p, ks in PATHS.items() if k in ks)
        rows.append({"name": k, "route": "cuda", "source": src,
                     "replaces": rep, "path": path,
                     "launches": path_launches[path].get(k, 0),
                     "max_abs_err": results[k]["max_abs_err"],
                     "ms": results[k]["ms"],
                     "plain_ms": results[k]["plain_ms"]})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
