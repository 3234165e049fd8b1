"""Build, load and launch the port's CUDA kernels (csrc/*.cu, and the
constraint-group kernels that air/codegen.py generates).

Each source compiles with its own nvcc process, all started together, and
the objects link into one shared library with a plain C interface, bound
with ctypes.  The build happens at the first launch, into ``_build/``
beside this file, under a name keyed by a hash of the sources, so a fresh
checkout builds everything on its first GPU call and an edited source
rebuilds.  Importing this module builds and loads nothing.

The second route, build_generated / generated_lib, compiles generated
sources: a library is a list of translation units, each compiled by its
own nvcc process, every missing library's units at once, and linked into
``_build/<name>.so``, its name a hash of the sources, the headers of csrc/
and the flags.  The sources are written beside it: the generator is the
repository's source, the generated files build products.

Every C entry returns ``cudaGetLastError()``; ``launch`` raises on a
nonzero code and counts the launch in ``LAUNCHES`` (by the name it is
given), which is how a run shows that its main path went through the
kernels.
"""

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry name -> argument types (every pointer and the stream are c_void_p)
SIGNATURES = {
    "fp252_add": [_P, _L, _L, _P, _L, _L, _P, _L, _P],
    "fp252_sub": [_P, _L, _L, _P, _L, _L, _P, _L, _P],
    "fp252_mul": [_P, _L, _L, _P, _L, _L, _P, _L, _P],
    "ntt_leaf": [_P, _P, _P, _I, _L, _P],
    "ntt_leaf_fused": [_P, _P, _P, _P, _I, _L, _L, _P],
    "open_pairs": [_P, _L, _P, _I, _P, _P, _I, _I, _L, _P, _P, _P, _P],
    "blake2s_rows": [_P, _L, _I, _I, _P, _P],
    "keccak_rows": [_P, _L, _I, _I, _P, _P],
    "pow_grind": [_P, _L, _I, _I, _L, _P, _P],
    "ec_madd_walk": [_P, _P, _P, _P, _I, _L, _P, _P, _P, _P],
    "gl_add": [_P, _L, _L, _P, _L, _L, _P, _L, _P],
    "gl_sub": [_P, _L, _L, _P, _L, _L, _P, _L, _P],
    "gl_mul": [_P, _L, _L, _P, _L, _L, _P, _L, _P],
    "gl3_mul": [_P, _L, _L, _P, _L, _L, _P, _L, _P],
    "gl_ntt_leaf": [_P, _P, _P, _I, _L, _P],
    "gl_ntt_leaf_fused": [_P, _P, _P, _P, _I, _L, _L, _P],
    "probe_alu": [_P, _P, _P, _I, _I, _L, _P],
    "fp252_scan_mul": [_P, _L, _I, _I, _I, _P, _P, _P],
    "fp252_batch_inv": [_P, _L, _L, _I, _I, _P, _P, _P, _P],
    "deep_compose": [_P, _P, _P, _P, _I, _I, _I, _L, _P, _P],
    "fp252_dot": [_P, _P, _I, _I, _P, _L, _P],
}

LAUNCHES = collections.Counter()

_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    cus, hdrs = _sources()
    h = hashlib.sha256()
    for f in cus + hdrs:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libsandstorm_kernels_{h.hexdigest()[:16]}.so"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> dict:
    """Compile the sources if the library for them is missing: one nvcc -c
    per source, all running at once, then one link.

    Returns {"path", "built", "seconds", "log"}; the log holds nvcc's
    -Xptxas -v report (registers, shared memory, spills per kernel)."""
    so = library_path()
    log_path = so.with_suffix(".log")
    if so.exists():
        return {"path": str(so), "built": False, "seconds": 0.0,
                "log": log_path.read_text() if log_path.exists() else ""}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cus, _ = _sources()
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{cu.stem}.o" for cu in cus]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for cu, obj in zip(cus, objs)]
    outs = [p.communicate() for p in procs]
    failed = [(cu.name, err) for cu, p, (_, err) in zip(cus, procs, outs)
              if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{name}:\n{err}" for name, err in failed))
    tmp = so.with_name(f"{tag}.tmp.so")
    link = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                           "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                           f"{link.stderr}")
    log = "".join(out + err for out, err in outs)
    log_path.write_text(log)
    os.replace(tmp, so)
    return {"path": str(so), "built": True, "seconds": seconds, "log": log}


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        path = build()["path"]
        handle = ctypes.CDLL(path)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def launch(name: str, device: torch.device, *args, fn=None):
    """Call C entry `name` (or the ctypes function `fn`, counted as `name`)
    on `device`'s current stream; raise on a CUDA error.  Pointer arguments
    are ints (tensor.data_ptr())."""
    fn = fn or getattr(lib(), name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        LAUNCHES[name] += 1
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: error {rc}")


def _headers_digest():
    h = hashlib.sha256()
    for f in _sources()[1]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h


def generated_path(stem: str, sources) -> Path:
    """Where the library of a generated source list lives (built or not)."""
    h = _headers_digest()
    for src in sources:
        h.update(src.encode())
    return BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"


def build_generated(libraries: dict) -> dict:
    """Build the libraries of generated sources ({stem: [CUDA source, ...]},
    each source a translation unit) that are missing: one nvcc -c a source,
    every missing library's sources all at once, then one link a library.
    Returns {stem: {"path", "built", "seconds", "log"}}; the log holds
    -Xptxas -v's registers, stack frame and spills per kernel, in source
    order."""
    out, jobs = {}, {}
    t0 = time.perf_counter()
    for stem, sources in libraries.items():
        so = generated_path(stem, sources)
        log_path = so.with_suffix(".log")
        if so.exists():
            out[stem] = {"path": str(so), "built": False, "seconds": 0.0,
                         "log": log_path.read_text()
                         if log_path.exists() else ""}
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{so.stem}.{os.getpid()}"
        parts = []
        for i, src in enumerate(sources):
            cu = so.with_name(f"{so.stem}.{i}.cu")
            cu.write_text(src)
            obj = so.with_name(f"{tag}.{i}.o")
            parts.append((obj, subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o",
                 str(obj), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        jobs[stem] = (so, tag, parts)
    failed = []
    for stem, (so, tag, parts) in jobs.items():
        outs = [proc.communicate() for _, proc in parts]
        bad = [err for (_, proc), (_, err) in zip(parts, outs)
               if proc.returncode != 0]
        objs = [obj for obj, _ in parts]
        if bad:
            failed.append(f"{stem}:\n" + "\n".join(bad))
        else:
            tmp = so.with_name(f"{tag}.tmp.so")
            link = subprocess.run(
                [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
                 "-shared", "-o", str(tmp), *map(str, objs)],
                capture_output=True, text=True)
            if link.returncode != 0:
                failed.append(f"{stem} (link):\n{link.stderr}")
            else:
                log = "".join(o + e for o, e in outs)
                so.with_suffix(".log").write_text(log)
                os.replace(tmp, so)
                out[stem] = {"path": str(so), "built": True,
                             "seconds": time.perf_counter() - t0,
                             "log": log}
        for obj in objs:
            obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


_generated = {}


def generated_lib(stem: str, sources, entries, argtypes):
    """The ctypes functions `entries` of a generated library (built on
    first use, then kept for the process by `stem`, which the caller
    derives from the sources), all with `argtypes`."""
    fns = _generated.get(stem)
    if fns is None:
        path = build_generated({stem: sources})[stem]["path"]
        handle = ctypes.CDLL(path)
        fns = []
        for entry in entries:
            fn = getattr(handle, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns.append(fn)
        _generated[stem] = fns
    return fns


def reset_counts():
    LAUNCHES.clear()


def check_cuda_tensor(t: torch.Tensor, name: str, dtype=torch.int32,
                      last_dim: int = None, align: int = 16):
    """Raise unless t is a contiguous CUDA tensor of dtype (and last dim)
    whose data pointer is `align`-byte aligned for the kernel's vector
    loads (16 for the Fp252 kernels' uint4, 8 for Goldilocks' u64)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if last_dim is not None and (t.dim() == 0 or t.shape[-1] != last_dim):
        raise ValueError(f"{name}: expected last dim {last_dim}, got "
                         f"{tuple(t.shape)}")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data pointer not {align}-byte aligned")
