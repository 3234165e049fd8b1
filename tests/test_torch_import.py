"""sandstorm_tpu_torch stands without jax and without the JAX package, and
builds nothing at import."""

import os
import pkgutil
import re
import subprocess
import sys

import sandstorm_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(sandstorm_tpu_torch.__file__)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG], prefix="sandstorm_tpu_torch."))


def test_imports_with_jax_absent_and_builds_nothing():
    """Every module imports in a fresh process where `import jax` and
    `import sandstorm_tpu` fail; importing builds no kernel library, no
    host Pedersen or witness library and no table, and launches
    nothing."""
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['sandstorm_tpu'] = None\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "from sandstorm_tpu_torch import _native, native\n"
        "assert _native._lib is None and not _native.LAUNCHES\n"
        "assert native._lib.cache_info().currsize == 0\n"
        "assert native._witness_lib.cache_info().currsize == 0\n"
        "assert not native.SECONDS\n"
        "assert native._window_tables.cache_info().currsize == 0\n"
        "assert not native.HASHES\n"
        "assert not any(k.startswith(('jax', 'jaxlib')) and v is not None\n"
        "               for k, v in sys.modules.items())\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("ok")


def test_no_file_imports_jax():
    pat = re.compile(r"^\s*(import\s+(jax|sandstorm_tpu)\b|"
                     r"from\s+(jax|sandstorm_tpu)\b)", re.M)
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d != "_build"]   # nvcc output, not source
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as fh:
            assert not pat.search(fh.read()), path
    assert len(_modules()) >= 20


def test_cairo_scheme_modules_are_listed():
    """The cairo scheme's modules, the host C++ loader among them, are part
    of the package that the import test walks."""
    assert {"sandstorm_tpu_torch.aux_input",
            "sandstorm_tpu_torch.builtins.curve",
            "sandstorm_tpu_torch.builtins.pedersen",
            "sandstorm_tpu_torch.crypto.coins",
            "sandstorm_tpu_torch.crypto.hashes",
            "sandstorm_tpu_torch.crypto.merkle_variants",
            "sandstorm_tpu_torch.hashing.pedersen",
            "sandstorm_tpu_torch.native"} <= set(_modules())


def test_recursive_layout_modules_are_listed():
    """The recursive layout's modules and the builtins beneath it are part
    of the package that the import test walks."""
    assert {"sandstorm_tpu_torch.builtins.bitwise",
            "sandstorm_tpu_torch.builtins.pedersen",
            "sandstorm_tpu_torch.layouts.recursive",
            "sandstorm_tpu_torch.layouts.recursive.air",
            "sandstorm_tpu_torch.layouts.recursive.trace",
            "sandstorm_tpu_torch.layouts.utils",
            "sandstorm_tpu_torch.tools.check_air"} <= set(_modules())


def test_eth_scheme_and_cli_modules_are_listed():
    """The eth scheme's modules (the Keccak kernel's wrapper, the grind),
    the artifact loader, the command line and the bundle writer are part
    of the package that the import test walks; importing __main__ runs
    nothing."""
    assert {"sandstorm_tpu_torch.__main__",
            "sandstorm_tpu_torch.cli",
            "sandstorm_tpu_torch.crypto.grind",
            "sandstorm_tpu_torch.examples",
            "sandstorm_tpu_torch.hashing.keccak",
            "sandstorm_tpu_torch.tools.make_artifacts"} <= set(_modules())


def test_starknet_layout_modules_are_listed():
    """The starknet layout's modules and the builtins beneath it are part
    of the package that the import test walks, and Poseidon's parameters
    are the package's own file."""
    assert {"sandstorm_tpu_torch.builtins.ec_op",
            "sandstorm_tpu_torch.builtins.ecdsa",
            "sandstorm_tpu_torch.builtins.poseidon",
            "sandstorm_tpu_torch.builtins.range_check",
            "sandstorm_tpu_torch.layouts.starknet",
            "sandstorm_tpu_torch.layouts.starknet.air",
            "sandstorm_tpu_torch.layouts.starknet.trace"} <= set(_modules())
    assert os.path.isfile(os.path.join(PKG, "builtins", "data",
                                       "poseidon_params.json"))


def test_fused_route_modules_are_listed_and_build_nothing():
    """The constraint-group code generator and the scan / DEEP wrappers are
    part of the package that the import test walks; in a fresh process
    where jax and sandstorm_tpu cannot be imported, importing them and
    lowering a layout's DAG to CUDA source builds and loads nothing."""
    assert {"sandstorm_tpu_torch.air.codegen",
            "sandstorm_tpu_torch.air.expr",
            "sandstorm_tpu_torch.fields.fp252_cuda",
            "sandstorm_tpu_torch.fields.scan",
            "sandstorm_tpu_torch.stark.prover"} <= set(_modules())
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['sandstorm_tpu'] = None\n"
        "from sandstorm_tpu_torch import _native\n"
        "from sandstorm_tpu_torch.air import codegen\n"
        "from sandstorm_tpu_torch.fields.fp252_cuda import scan_mul\n"
        "from sandstorm_tpu_torch.stark.prover import deep_compose\n"
        "from sandstorm_tpu_torch.layouts.plain.air import PlainAirConfig\n"
        "plan = codegen.air_plan(PlainAirConfig, 1 << 10, 2)\n"
        "assert '__global__' in plan.source and len(plan.groups) == 6\n"
        "assert _native._lib is None and not _native._generated\n"
        "assert not _native.LAUNCHES\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("ok")


def test_parallel_modules_are_listed_and_build_nothing():
    """The multi-device modules are part of the package that the import
    test walks; in a fresh process where jax and sandstorm_tpu cannot be
    imported, importing them, making a CPU mesh and calling the one-process
    initialize builds and launches nothing and joins no process group."""
    assert {"sandstorm_tpu_torch.parallel",
            "sandstorm_tpu_torch.parallel.dist",
            "sandstorm_tpu_torch.parallel.multihost",
            "sandstorm_tpu_torch.parallel.runtime"} <= set(_modules())
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['sandstorm_tpu'] = None\n"
        "import torch\n"
        "from sandstorm_tpu_torch import _native, _tables\n"
        "from sandstorm_tpu_torch.parallel import (dist, make_mesh,\n"
        "                                          multihost, runtime)\n"
        "multihost.initialize()\n"
        "mesh = make_mesh(4, device='cpu')\n"
        "assert mesh.size == 4 and runtime.active_mesh() is None\n"
        "assert not torch.distributed.is_initialized()\n"
        "assert _native._lib is None and not _native.LAUNCHES\n"
        "assert dist.NTT_CALLS == 0 and not _tables._CACHE\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONSTARTUP", "MASTER_ADDR", "WORLD_SIZE")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("ok")
