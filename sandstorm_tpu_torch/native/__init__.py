"""Host C++ for the port, built with the system c++ and bound with ctypes
(copy of sandstorm_tpu/native/__init__.py): the Pedersen hash batch
(pedersen.cpp) and the lockstep builtin witness batch (ecdsa.cpp, over
fe252.h) of the ECDSA, EC-op and Pedersen builtins.

Each library builds at first use into ``_build/`` beside the package, under
a name keyed by a hash of its sources and the flags, as ``_native.py`` keys
the nvcc library; importing this module builds and loads nothing.  A failed
build raises, and so does a batch whose library state is not set: there is
no python fallback.

``HASHES`` counts Pedersen hashes by route: "host" (this batch), "cuda"
(the ec_madd_walk kernel) and "cpu" (the kernel's plain PyTorch version),
so a run can show where its hashing went: a Counter of the recorder
(telemetry.tally), each hash also counted as ``hashes.<route>`` on the
innermost open span.  Each witness batch call runs in a span
``native.<entry>`` (the lockstep alone, without the packing of its
inputs).
"""

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from .. import telemetry
from ..layouts.utils import ints_to_u64limbs

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parent / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
# library -> its sources, the translation unit first (the rest are headers)
SOURCES = {"pedersen": (HERE / "pedersen.cpp",),
           "witness": (HERE / "ecdsa.cpp", HERE / "fe252.h")}

HASHES = telemetry.tally("hashes")


def library_path(name: str = "pedersen") -> Path:
    h = hashlib.sha256()
    for src in SOURCES[name]:
        h.update(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libsandstorm_{name}_{h.hexdigest()[:16]}.so"


def build(name: str = "pedersen") -> Path:
    """Compile library `name` unless the library for its sources exists."""
    so = library_path(name)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        ["c++", *CXX_FLAGS, "-o", str(tmp), str(SOURCES[name][0])],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"c++ failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def _int_to_limbs(v: int) -> np.ndarray:
    return np.frombuffer(int(v).to_bytes(32, "little"), dtype="<u8").copy()


@functools.lru_cache(maxsize=1)
def _window_tables() -> tuple:
    """The 8-bit window tables: ([2, 32, 256, 8] u64, [8] u64), x limbs
    then y limbs of affine points in Montgomery form (R = 2^256).

    Window w of input s holds v * B for v = 0..255 (entry 0 unused), with
      B = 2^(8w) * P_low   for w < 31  (the 248 low bits ride P1 / P3)
      B = P_high           for w = 31  (bits 248-251 ride P2 / P4),
    the split of the reference's Pedersen subset sum; the shift is P0."""
    from ..builtins.curve import P as MOD, ec_add, ec_mul
    from ..builtins.pedersen import shift_and_table_points
    p0, p1, p2, p3, p4 = shift_and_table_points()
    R = 1 << 256

    def mont(v):
        return _int_to_limbs(v * R % MOD)

    table = np.zeros((2, 32, 256, 8), dtype="<u8")
    for scalar, (lo, hi) in enumerate(((p1, p2), (p3, p4))):
        for w in range(32):
            base = ec_mul(1 << (8 * w), lo) if w < 31 else hi
            acc = None
            for v in range(1, 256):
                acc = base if acc is None else ec_add(acc, base)
                table[scalar, w, v, :4] = mont(acc[0])
                table[scalar, w, v, 4:] = mont(acc[1])
    shift = np.concatenate([mont(p0[0]), mont(p0[1])])
    return table, shift


@functools.lru_cache(maxsize=1)
def _lib():
    lib = ctypes.CDLL(str(build("pedersen")))
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.pedersen_set_table.argtypes = [u64p, u64p]
    lib.pedersen_set_table.restype = None
    lib.pedersen_hash_pairs.argtypes = [u64p, u64p, u64p, ctypes.c_size_t]
    lib.pedersen_hash_pairs.restype = ctypes.c_int
    table, shift = _window_tables()
    tflat = np.ascontiguousarray(table.reshape(-1))
    sflat = np.ascontiguousarray(shift)
    lib.pedersen_set_table(tflat.ctypes.data_as(u64p),
                           sflat.ctypes.data_as(u64p))
    lib._table_keepalive = (tflat, sflat)
    return lib


def pedersen_hash_pairs(a_limbs: np.ndarray, b_limbs: np.ndarray) -> np.ndarray:
    """Batched Pedersen hash: [k, 4] canonical LE u64 limb arrays -> [k, 4]."""
    a = np.ascontiguousarray(a_limbs, dtype="<u8")
    b = np.ascontiguousarray(b_limbs, dtype="<u8")
    if a.ndim != 2 or a.shape[1] != 4 or a.shape != b.shape:
        raise ValueError(f"pedersen_hash_pairs: shapes {a.shape}, {b.shape}")
    k = a.shape[0]
    out = np.empty((k, 4), dtype="<u8")
    u64p = ctypes.POINTER(ctypes.c_uint64)
    rc = _lib().pedersen_hash_pairs(a.ctypes.data_as(u64p),
                                    b.ctypes.data_as(u64p),
                                    out.ctypes.data_as(u64p), k)
    if rc != 0:
        raise RuntimeError(f"pedersen_hash_pairs failed: {rc}")
    HASHES.add("host", k)
    return out


def pedersen_hash_pairs_ints(a_ints, b_ints):
    """Lists of python ints -> list of python ints."""
    a = np.stack([_int_to_limbs(v) for v in a_ints])
    b = np.stack([_int_to_limbs(v) for v in b_ints])
    out = pedersen_hash_pairs(a, b)
    return [int.from_bytes(row.tobytes(), "little") for row in out]


# -- the lockstep builtin witness batch (ecdsa.cpp) ---------------------------

# felts an instance in each batch's output (their layout is in ecdsa.cpp)
ECDSA_OUT_FELTS = 6160
PEDERSEN_WITNESS_OUT_FELTS = 1538
EC_OP_OUT_FELTS = 2306


@functools.lru_cache(maxsize=1)
def _witness_lib():
    """The witness library with its process-global state set once: the
    shift point and the generator (ecdsa_set_params), and the Pedersen
    doubling chains of both inputs (pedersen_set_chains)."""
    from ..builtins.curve import GENERATOR
    from ..builtins.pedersen import _chain, shift_and_table_points
    lib = ctypes.CDLL(str(build("witness")))
    u64p, intp = ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int)
    lib.ecdsa_set_params.argtypes = [u64p, u64p]
    lib.ecdsa_set_params.restype = None
    lib.pedersen_set_chains.argtypes = [u64p, u64p]
    lib.pedersen_set_chains.restype = None
    lib.ecdsa_witness_batch.argtypes = [u64p] * 6 + [intp, ctypes.c_size_t]
    lib.ecdsa_witness_batch.restype = ctypes.c_int
    lib.ec_op_witness_batch.argtypes = [u64p] * 6 + [intp, ctypes.c_size_t]
    lib.ec_op_witness_batch.restype = ctypes.c_int
    lib.pedersen_witness_batch.argtypes = [u64p] * 3 + [intp,
                                                        ctypes.c_size_t]
    lib.pedersen_witness_batch.restype = ctypes.c_int
    shift = shift_and_table_points()[0]
    shift_xy = ints_to_u64limbs(shift).reshape(-1)
    gen_xy = ints_to_u64limbs(GENERATOR).reshape(-1)
    lib.ecdsa_set_params(shift_xy.ctypes.data_as(u64p),
                         gen_xy.ctypes.data_as(u64p))
    # [252, 8] a chain: x limbs then y limbs of each point
    chains = [ints_to_u64limbs(c for pt in _chain(which) for c in pt)
              .reshape(-1) for which in (0, 1)]
    lib.pedersen_set_chains(chains[0].ctypes.data_as(u64p),
                            chains[1].ctypes.data_as(u64p))
    return lib


def _limbs(vals) -> np.ndarray:
    """[k, 4] canonical LE u64 limbs of python ints (one bytes join), or
    the same array if it is one already."""
    if isinstance(vals, np.ndarray):
        a = np.ascontiguousarray(vals, dtype="<u8")
        if a.ndim != 2 or a.shape[1] != 4:
            raise ValueError(f"limb array of shape {a.shape}")
        return a
    return np.ascontiguousarray(ints_to_u64limbs(vals))


def _run(entry: str, felts: int, inputs):
    """One batch call: inputs (lists of python ints or [k, 4] limb arrays,
    all of one length) -> (out [k, felts, 4] canonical LE u64 limbs,
    status [k] int32)."""
    arrs = [_limbs(v) for v in inputs]
    k = arrs[0].shape[0]
    if any(a.shape[0] != k for a in arrs):
        raise ValueError(f"{entry}: inputs of lengths "
                         f"{[a.shape[0] for a in arrs]}")
    out = np.empty((k, felts, 4), dtype="<u8")
    status = np.empty(k, dtype=np.int32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    fn = getattr(_witness_lib(), entry)
    with telemetry.span("native." + entry, instances=k):
        rc = fn(*[a.ctypes.data_as(u64p) for a in arrs],
                out.ctypes.data_as(u64p),
                status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), k)
    if rc == -1:
        raise RuntimeError(f"{entry}: the library's parameters are not set")
    if rc != 0:
        raise RuntimeError(f"{entry} failed: {rc}")
    return out, status


def ecdsa_witness_batch(msg, r, w, pubx, puby):
    """Batched ECDSA builtin witness.  status: 0 ok, 1 a mimic x-collision
    (AIR-invalid), 2 r mismatch, 3 a degenerate point."""
    return _run("ecdsa_witness_batch", ECDSA_OUT_FELTS,
                (msg, r, w, pubx, puby))


def pedersen_witness_batch(a_vals, b_vals):
    """Batched Pedersen builtin witness.  status: 0 ok, 1 AIR-invalid."""
    return _run("pedersen_witness_batch", PEDERSEN_WITNESS_OUT_FELTS,
                (a_vals, b_vals))


def ec_op_witness_batch(px, py, qx, qy, m):
    """Batched EC-op builtin witness, r = p + m q.  status: 0 ok, 1 a
    mimic x-collision, 3 a degenerate point."""
    return _run("ec_op_witness_batch", EC_OP_OUT_FELTS, (px, py, qx, qy, m))
