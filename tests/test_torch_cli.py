"""The artifact loader and the command line on the CPU: bundles written by
sandstorm_tpu_torch/tools/make_artifacts.py load, in both packages'
load_artifacts, to the claim they came from; the port's CLI with
--device cpu writes the pinned tiny proofs (tests/data/self_proof_*.bin)
and the JAX package's GF(p^3) bytes, the JAX CLI accepts its proof, a
tampered proof is rejected, --device cuda without a card raises, and the
starknet stand-in's bundle loads in both packages and picks the eth
scheme.  Tolerance 0: arrays and proof bytes are exact."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from sandstorm_tpu_torch import cli
from sandstorm_tpu_torch.claims import loop_claim, recursive_loop_claim
from sandstorm_tpu_torch.examples import load_artifacts
from sandstorm_tpu_torch.tools.make_artifacts import (loop_bundle,
                                                      recursive_bundle)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
CPU = torch.device("cpu")
TINY = ["--num-queries", "4", "--proof-of-work-bits", "4"]
# sha256 of the JAX package's tiny GF(p^3) proof (chip_smoke.TINY_SHA256)
GL3_TINY_SHA256 = \
    "c5e6371ad984c35655849e4307ba578c4c58bd80fef54dc921cdaac26a64185f"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain twins run some 10^4 small ops over a 2^16-nonce grind
    batch; with every test process using all cores, the intra-op thread
    pools oversubscribe the CPU and such a batch runs over a hundred times
    slower.  One thread keeps it near its single-process time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pinned(scheme):
    with open(os.path.join(DATA, f"self_proof_{scheme}.bin"), "rb") as f:
        return f.read()


def _pub_key(pub):
    """A public input of either package as plain values."""
    return (pub.layout.value, pub.rc_min, pub.rc_max, pub.n_steps,
            {k: (s.begin_addr, s.stop_ptr)
             for k, s in pub.memory_segments.items()},
            [(e.address, e.value) for e in pub.public_memory])


def _builtins(priv):
    return [getattr(priv, k) for k in ("pedersen", "range_check", "ecdsa",
                                       "bitwise", "ec_op", "poseidon")]


def _assert_loads_to(paths, claim, witness):
    """Both packages' load_artifacts give the claim's registers, memory,
    public input and builtin instances."""
    from sandstorm_tpu.examples import load_artifacts as jax_load
    args = (paths["program"], paths["public"], paths["private"])
    for _, pub, w in (load_artifacts(*args), jax_load(*args)):
        assert _pub_key(pub) == _pub_key(claim.public_input)
        assert np.array_equal(w.register_states.arr,
                              witness.register_states.arr)
        assert np.array_equal(w.memory.values, witness.memory.values)
        assert np.array_equal(w.memory.known, witness.memory.known)
        assert _builtins(w.air_private_input) == \
            _builtins(witness.air_private_input)


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    base = tmp_path_factory.mktemp("bundles")
    return {field: loop_bundle(str(base / field), 16, field)
            for field in ("fp252", "goldilocks")}


@pytest.mark.parametrize("field", ["fp252", "goldilocks"])
def test_loop_bundle_loads_in_both_packages(bundles, field):
    from sandstorm_tpu.examples import load_artifacts as jax_load
    claim, witness = loop_claim(16, CPU)
    _assert_loads_to(bundles[field], claim, witness)
    program, _, _ = load_artifacts(bundles[field]["program"],
                                   bundles[field]["public"],
                                   bundles[field]["private"])
    jprogram, _, _ = jax_load(bundles[field]["program"],
                              bundles[field]["public"],
                              bundles[field]["private"])
    assert program.data == jprogram.data and program.prime == jprogram.prime
    assert [(e.address, e.value) for e in program.program_memory()] == \
        [(e.address, e.value) for e in claim.public_input.public_memory]


def test_tiny_artifacts_of_the_jax_tool_load_the_same(bundles, tmp_path):
    """tools/make_tiny_artifacts.py's bundle of 16 steps loads in the port
    to the arrays of the port's own bundle."""
    import subprocess
    import sys
    subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                  "make_tiny_artifacts.py"),
                    str(tmp_path), "16"], check=True, capture_output=True,
                   env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=300)
    theirs = load_artifacts(str(tmp_path / "program.json"),
                            str(tmp_path / "air-public-input.json"),
                            str(tmp_path / "air-private-input.json"))
    ours = load_artifacts(bundles["fp252"]["program"],
                          bundles["fp252"]["public"],
                          bundles["fp252"]["private"])
    assert theirs[0] == ours[0]
    assert _pub_key(theirs[1]) == _pub_key(ours[1])
    for a, b in zip(theirs[2:], ours[2:]):
        assert np.array_equal(a.register_states.arr, b.register_states.arr)
        assert np.array_equal(a.memory.values, b.memory.values)


def test_recursive_bundle_loads_to_its_claim(tmp_path):
    """The recursive stand-in's bundle keeps its output, pedersen,
    range_check and bitwise segments and its Pedersen and bitwise
    instances."""
    paths = recursive_bundle(str(tmp_path), 1 << 14)
    claim, witness = recursive_loop_claim(1 << 14, CPU)
    _assert_loads_to(paths, claim, witness)
    with open(paths["public"]) as f:
        assert {"output", "pedersen", "range_check", "bitwise"} <= set(
            json.load(f)["memory_segments"])
    assert len(witness.air_private_input.pedersen) == 3


def _argv(paths, *rest, scheme=None):
    out = ["--program", paths["program"], "--air-public-input",
           paths["public"]]
    return out + (["--scheme", scheme] if scheme else []) + list(rest)


@pytest.mark.parametrize("scheme", ["eth", None])
def test_cli_writes_the_pinned_tiny_proofs(bundles, tmp_path, capsys,
                                           scheme):
    """--scheme eth writes self_proof_eth.bin; no scheme on the plain layout
    dispatches to the generic scheme, self_proof_generic.bin.  The three
    printed lines, then verify through the port's CLI."""
    out = str(tmp_path / "proof.bin")
    assert cli.main(_argv(bundles["fp252"], "prove", "--device", "cpu",
                          "--air-private-input", bundles["fp252"]["private"],
                          "--output", out, *TINY, scheme=scheme)) == 0
    with open(out, "rb") as f:
        assert f.read() == _pinned(scheme or "generic")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("proof generated in ")
    assert lines[1] == "proof security (conjectured): 8bit"
    assert lines[2] == f"proof size: {len(_pinned('generic')) / 1024:.1f}KB"
    assert cli.main(_argv(bundles["fp252"], "verify", "--proof", out,
                          "--required-security-bits", "8",
                          scheme=scheme)) == 0


def test_jax_cli_accepts_the_port_cli_proof(bundles, tmp_path, monkeypatch):
    from sandstorm_tpu.cli import main as jax_main
    monkeypatch.setenv("SANDSTORM_TPU_NO_PROBE", "1")
    out = str(tmp_path / "proof.bin")
    cli.main(_argv(bundles["fp252"], "prove", "--device", "cpu",
                   "--air-private-input", bundles["fp252"]["private"],
                   "--output", out, *TINY, scheme="eth"))
    assert jax_main(_argv(bundles["fp252"], "verify", "--proof", out,
                          "--required-security-bits", "8",
                          scheme="eth")) == 0


@pytest.mark.parametrize("scheme", ["eth", "generic"])
def test_cli_rejects_a_tampered_proof(bundles, tmp_path, scheme):
    bad = bytearray(_pinned(scheme))
    bad[len(bad) // 2] ^= 0x01
    path = tmp_path / "bad.bin"
    path.write_bytes(bytes(bad))
    with pytest.raises(SystemExit, match="proof rejected"):
        cli.main(_argv(bundles["fp252"], "verify", "--proof", str(path),
                       "--required-security-bits", "8", scheme=scheme))


def test_cli_goldilocks_bundle_proves_in_gl3(bundles, tmp_path):
    """A Goldilocks prime dispatches to GF(p^3) challenges under the generic
    scheme; the proof is the JAX package's."""
    out = str(tmp_path / "proof.bin")
    cli.main(_argv(bundles["goldilocks"], "prove", "--device", "cpu",
                   "--air-private-input", bundles["goldilocks"]["private"],
                   "--output", out, *TINY))
    with open(out, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == GL3_TINY_SHA256


def test_field_and_scheme_dispatch():
    from sandstorm_tpu_torch.binary.formats import Layout
    from sandstorm_tpu_torch.fields.fp252 import Fp252
    from sandstorm_tpu_torch.fields.gl3 import GL3
    from sandstorm_tpu_torch.fields.goldilocks import GL
    assert cli._field_for_prime(Fp252.MODULUS) is Fp252
    assert cli._field_for_prime(GL.MODULUS) is GL3
    with pytest.raises(SystemExit, match="unsupported field prime"):
        cli._field_for_prime(101)
    assert cli.scheme_for(Layout.RECURSIVE, Fp252) == "cairo"
    assert cli.scheme_for(Layout.STARKNET, Fp252) == "eth"
    assert cli.scheme_for(Layout.PLAIN, Fp252) == "generic"
    assert cli.scheme_for(Layout.RECURSIVE, GL3) == "generic"
    assert cli.scheme_for(Layout.RECURSIVE, Fp252, "eth") == "eth"


def test_cli_cuda_without_a_card_raises(bundles, tmp_path):
    """The default device is cuda; without a card prove raises and writes
    nothing: there is no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = tmp_path / "proof.bin"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(_argv(bundles["fp252"], "prove", "--air-private-input",
                       bundles["fp252"]["private"], "--output", str(out),
                       *TINY))
    assert not out.exists()


def test_starknet_bundle_loads_to_its_claim_and_picks_eth(tmp_path):
    """The starknet stand-in's bundle (131072 steps) loads in both
    packages' load_artifacts to its claim's arrays, public input and
    instances of every builtin, and the CLI's dispatch proves it under
    the eth scheme (the EthVerifierClaim) in the 252-bit field."""
    from sandstorm_tpu_torch.claims import CairoClaim, starknet_loop_claim
    from sandstorm_tpu_torch.fields.fp252 import Fp252
    from sandstorm_tpu_torch.tools.make_artifacts import starknet_bundle
    paths = starknet_bundle(str(tmp_path), 1 << 17)
    claim, witness = starknet_loop_claim(1 << 17, CPU)
    _assert_loads_to(paths, claim, witness)
    program, pub, _ = load_artifacts(paths["program"], paths["public"],
                                     paths["private"])
    F = cli._field_for_prime(program.prime)
    assert F is Fp252 and pub.layout.value == "starknet"
    assert cli.scheme_for(pub.layout, F) == "eth"
    cli_claim = CairoClaim(program, pub, device=CPU, field=F,
                           scheme=cli.scheme_for(pub.layout, F))
    assert cli_claim.scheme.name == "eth"
    assert cli_claim.air_config is claim.air_config
    assert [len(x) for x in _builtins(witness.air_private_input)] == \
        [3, 2, 2, 3, 2, 3]
