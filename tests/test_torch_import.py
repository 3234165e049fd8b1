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
    host Pedersen library and no table, and launches nothing."""
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['sandstorm_tpu'] = None\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "from sandstorm_tpu_torch import _native, native\n"
        "assert _native._lib is None and not _native.LAUNCHES\n"
        "assert native._lib.cache_info().currsize == 0\n"
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
