"""Host C++ Pedersen batch (pedersen.cpp), built with the system c++ and
bound with ctypes (trimmed copy of sandstorm_tpu/native/__init__.py).

The library builds at first use into ``_build/`` beside the package, under
a name keyed by a hash of the source and the flags, as ``_native.py`` keys
the nvcc library; importing this module builds and loads nothing.  A failed
build raises.

``HASHES`` counts Pedersen hashes by route: "host" (this batch), "cuda"
(the ec_madd_walk kernel) and "cpu" (the kernel's plain PyTorch version),
so a run can show where its hashing went.
"""

import collections
import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "pedersen.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

HASHES = collections.Counter()


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libsandstorm_pedersen_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile pedersen.cpp unless the library for it exists."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(["c++", *CXX_FLAGS, "-o", str(tmp), str(SRC)],
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
    lib = ctypes.CDLL(str(build()))
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
    HASHES["host"] += k
    return out


def pedersen_hash_pairs_ints(a_ints, b_ints):
    """Lists of python ints -> list of python ints."""
    a = np.stack([_int_to_limbs(v) for v in a_ints])
    b = np.stack([_int_to_limbs(v) for v in b_ints])
    out = pedersen_hash_pairs(a, b)
    return [int.from_bytes(row.tobytes(), "little") for row in out]
