#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sandstorm_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, one JSON object per line:
  1. device and toolchain (torch, CUDA, nvcc, nvidia-smi, triton);
  2. the nvcc build of csrc/*.cu, with its time and registers per kernel;
  3. every kernel against its plain PyTorch twin on the card, bit-exact
     (tolerance 0: field arithmetic, transforms, openings and hashes are
     exact), with the kernel's time beside the plain version's;
  4. the tiny plain/generic proof on the card, which must equal
     tests/data/self_proof_generic.bin byte for byte;
  5. the slice at size: a 2^16-step plain-layout run proved under the
     generic scheme with the default ProofOptions (trace 2^20 rows, LDE
     2^21), twice, accepted by the port's verifier and rejected with one
     byte flipped; every kernel's launch count in the first prove must be
     > 0.
Then the nvidia-smi line, the kernels table {"kernels": [...]}, and last
{"ok": true, "device": {...}}.  Any failure raises before the last line.
Without a CUDA device, or without the repository around it, the script
exits non-zero and prints no result.
"""

import json
import os
import random
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
STEPS = 1 << 16

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
}


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


def max_abs_err(torch, a, b):
    """Largest |difference| of the u32 words of two limb tensors."""
    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    da = a.to(torch.int64) & 0xFFFFFFFF
    db = b.to(torch.int64) & 0xFFFFFFFF
    return int((da - db).abs().max().item()) if a.numel() else 0


def ptxas_registers(log):
    """{kernel: registers} from nvcc's -Xptxas -v report."""
    names = [("blake2s_kernel", "blake2s_rows"),
             ("binop_kernelILi0", "fp252_add"),
             ("binop_kernelILi1", "fp252_sub"),
             ("binop_kernelILi2", "fp252_mul"),
             ("ntt_leaf_kernel", "ntt_leaf"),
             ("open_pairs_partial_kernel", "open_pairs_partial"),
             ("open_pairs_reduce_kernel", "open_pairs_reduce")]
    out, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = next((n for key, n in names if key in line), None)
        elif "Used" in line and "registers" in line and cur:
            out[cur] = int(line.split("Used")[1].split()[0])
    return out


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from sandstorm_tpu_torch import _native
    from sandstorm_tpu_torch.claims import loop_claim
    from sandstorm_tpu_torch.fields import fp252_cuda as fc
    from sandstorm_tpu_torch.fields.fp252 import Fp252 as F
    from sandstorm_tpu_torch.hashing import blake2s
    from sandstorm_tpu_torch.layouts.plain.air import PlainAirConfig
    from sandstorm_tpu_torch.ntt import ntt
    from sandstorm_tpu_torch.ntt import ntt_cuda
    from sandstorm_tpu_torch.stark import prover
    from sandstorm_tpu_torch.stark.ark import parse_proof, serialize_proof
    from sandstorm_tpu_torch.stark.openings import point_powers
    from sandstorm_tpu_torch.stark.options import ProofOptions
    from sandstorm_tpu_torch.stark.verifier import VerificationError
    from sandstorm_tpu_torch.air.expr import trace_arguments

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
          "registers": ptxas_registers(info["log"])})

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
    import hashlib
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

    # -- 4: the tiny proof on the card ---------------------------------------
    claim, witness = loop_claim(16, dev)
    t0 = time.perf_counter()
    blob = serialize_proof(claim.prove(
        witness, ProofOptions(num_queries=4, proof_of_work_bits=4)))
    tiny_s = time.perf_counter() - t0
    with open(os.path.join(ROOT, "tests", "data",
                           "self_proof_generic.bin"), "rb") as f:
        pinned = f.read()
    check(blob == pinned, "tiny GPU proof differs from the pinned bytes")
    emit({"phase": "tiny_proof", "equal_to_pinned": True,
          "bytes": len(blob), "prove_s": tiny_s})

    # -- 5: the slice at size ------------------------------------------------
    t0 = time.perf_counter()
    claim, witness = loop_claim(STEPS, dev)
    witness_s = time.perf_counter() - t0
    options = ProofOptions()
    _native.reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    proof = claim.prove(witness, options)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(_native.LAUNCHES)
    phases_first = [[k, v] for k, v in prover.LAST_PHASES]
    peak_first = torch.cuda.max_memory_allocated(dev)
    missing = [k for k in KERNELS if launches.get(k, 0) == 0]
    check(not missing, f"main path launched no {missing}")

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    proof2 = claim.prove(witness, options)
    torch.cuda.synchronize()
    second_s = time.perf_counter() - t0
    peak_second = torch.cuda.max_memory_allocated(dev)
    blob = serialize_proof(proof)
    check(serialize_proof(proof2) == blob, "two proves of one claim differ")

    t0 = time.perf_counter()
    check(claim.verify(parse_proof(blob)), "port verifier rejected the proof")
    verify_s = time.perf_counter() - t0
    bad = bytearray(blob)
    bad[len(bad) // 2] ^= 0x01
    try:
        claim.verify(parse_proof(bytes(bad)))
        rejected = False
    except (VerificationError, AssertionError):
        rejected = True
    check(rejected, "port verifier accepted a proof with one byte flipped")
    emit({"phase": "slice", "steps": STEPS,
          "trace_rows": proof.trace_len,
          "lde_rows": proof.trace_len * options.lde_blowup_factor,
          "options": list(proof.options), "witness_s": witness_s,
          "first_prove_s": first_s, "prove_s": second_s,
          "steps_per_s": STEPS / second_s,
          "phases_first": phases_first,
          "phases": [[k, v] for k, v in prover.LAST_PHASES],
          "peak_mem_bytes_first": peak_first,
          "peak_mem_bytes": peak_second, "proof_bytes": len(blob),
          "verify_s": verify_s, "tampered_rejected": rejected,
          "launches": launches})

    print(smi, flush=True)
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": results[k]["max_abs_err"],
         "ms": results[k]["ms"], "plain_ms": results[k]["plain_ms"]}
        for k, (src, rep) in KERNELS.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
