"""The port's multi-device proving (sandstorm_tpu_torch/parallel) against
the JAX package, on the CPU, and the proof-of-work grind's windows.

- dist_ntt on 4- and 8-shard CPU meshes against the JAX package's
  single-device ntt and the port's own, both directions, one and three
  columns; dist_coset_lde against the JAX coset_lde.
- The JAX package's own dist_ntt, dist_coset_lde and dist_prove_step on an
  8-device CPU mesh, run in a subprocess (a shard_map run leaves state in
  the process that later JAX tests trip over), against the port's on the
  same inputs.
- The tiny claims proved under a mesh: the pinned generic and cairo bytes,
  the JAX package's Goldilocks and GF(p^3) digests; a two-process gloo
  prove (file rendezvous, two CPU shards a process) to the pinned bytes in
  both processes; the multi-process helpers in one process.
- The grind: a window's plain twin against the batch-by-batch loop, with
  the first hit in batch 0, in batch 1 and past the first window; grind()
  returns the nonces it returned before the windows.

Inputs come from numpy seeds; tolerance 0 (field elements and bytes).
"""

import hashlib
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import TINY_SHA256
from sandstorm_tpu.fields.fp252 import Fp252 as JF
from sandstorm_tpu.fields.goldilocks import GL as JGL
from sandstorm_tpu.ntt import coset_lde as jax_coset_lde
from sandstorm_tpu.ntt import ntt as jax_ntt
from sandstorm_tpu_torch.claims import loop_claim
from sandstorm_tpu_torch.crypto import grind as g
from sandstorm_tpu_torch.crypto.hashes import blake2s256, keccak256
from sandstorm_tpu_torch.fields.fp252 import Fp252
from sandstorm_tpu_torch.fields.gl3 import GL3
from sandstorm_tpu_torch.fields.goldilocks import GL
from sandstorm_tpu_torch.interop import from_jax_digits, to_jax_digits
from sandstorm_tpu_torch.ntt import ntt
from sandstorm_tpu_torch.parallel import (dist, dist_coset_lde, dist_ntt,
                                          dist_prove_step, make_mesh,
                                          multihost, runtime, shard0)
from sandstorm_tpu_torch.parallel.dist import gather
from sandstorm_tpu_torch.stark.ark import parse_proof, serialize_proof
from sandstorm_tpu_torch.stark.options import ProofOptions

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TINY = ProofOptions(num_queries=4, proof_of_work_bits=4)
FIELDS = {"goldilocks": (GL, JGL, 256), "fp252": (Fp252, JF, 64)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The grind's plain twin runs many small ops a batch; one intra-op
    thread keeps it near its single-process time under the test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _words(JFd, rng, shape):
    """Seeded elements as the JAX package's numpy words ([..., 2] u32 for
    Goldilocks, [..., 16] u32 digits for Fp252)."""
    bound = JFd.MODULUS
    vals = [int.from_bytes(rng.bytes(32), "little") % bound
            for _ in range(int(np.prod(shape)))]
    words = np.asarray(JFd.encode_ints_np(vals))
    return words.reshape(tuple(shape) + words.shape[-1:])


def _port(F, words):
    if F is Fp252:
        return from_jax_digits(words)
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32).copy())


def _as_jax(F, t):
    return to_jax_digits(t) if F is Fp252 else t.numpy().view(np.uint32)


# -- in process: the port's dist_* against the JAX single-device transforms --

@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("D", [4, 8])
@pytest.mark.parametrize("field", ["goldilocks", "fp252"])
def test_dist_ntt_matches_jax_ntt(field, D, B):
    F, JFd, n = FIELDS[field]
    words = _words(JFd, np.random.default_rng(n + D + B), (n, B))
    x = _port(F, words)
    mesh = make_mesh(D, device="cpu")
    before = dist.NTT_CALLS
    fwd = gather(dist_ntt(F, mesh, shard0(x, mesh)), mesh, CPU)
    assert dist.NTT_CALLS == before + 1
    for b in range(B):
        want = np.asarray(jax_ntt(JFd, jnp.asarray(words[:, b])))
        assert np.array_equal(_as_jax(F, fwd[:, b].contiguous()), want)
    assert torch.equal(fwd, ntt(F, x))
    back = gather(dist_ntt(F, mesh, fwd, inverse=True), mesh, CPU)
    assert torch.equal(back, x)


@pytest.mark.parametrize("D", [4, 8])
def test_dist_coset_lde_matches_jax(D):
    n, blowup = 128, 2
    words = _words(JGL, np.random.default_rng(23), (n,))
    mesh = make_mesh(D, device="cpu")
    got = gather(dist_coset_lde(GL, mesh, _port(GL, words), blowup,
                                GL.GENERATOR), mesh, CPU)
    want = np.asarray(jax_coset_lde(JGL, jnp.asarray(words), blowup,
                                    JGL.GENERATOR))
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_mesh_helpers():
    """shard0 splits rows into natural-order chunks, four_step_ok wants D
    to divide both halves of the split, an active mesh scope nests, and
    make_mesh without a device wants a card."""
    mesh = make_mesh(4, device="cpu")
    assert mesh.size == 4 and mesh.local == 4 and mesh.world == 1
    x = torch.arange(32, dtype=torch.int32).reshape(16, 2)
    parts = shard0(x, mesh)
    assert [p[:, 0].tolist() for p in parts] == \
        [[0, 2, 4, 6], [8, 10, 12, 14], [16, 18, 20, 22], [24, 26, 28, 30]]
    assert torch.equal(gather(parts, mesh, CPU), x)
    assert runtime.four_step_ok(16, mesh) and runtime.four_step_ok(64, mesh)
    assert not runtime.four_step_ok(8, mesh)     # 2 x 4
    assert not runtime.four_step_ok(32, make_mesh(8, device="cpu"))
    assert runtime.active_mesh() is None and shard0(x) is x
    with runtime.mesh_scope(mesh):
        assert runtime.active_mesh() is mesh
        inner = make_mesh(8, device="cpu")
        with runtime.mesh_scope(inner):
            assert runtime.active_mesh() is inner
        assert runtime.active_mesh() is mesh
    assert runtime.active_mesh() is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh(4)


# -- the JAX package's own mesh functions, in a subprocess -------------------

_JAX_MESH_SCRIPT = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from sandstorm_tpu import enable_compile_cache
enable_compile_cache()
from sandstorm_tpu.fields.fp252 import Fp252
from sandstorm_tpu.fields.goldilocks import GL
from sandstorm_tpu.parallel import (make_mesh, dist_ntt, dist_coset_lde,
                                    dist_prove_step)

d = sys.argv[1]
assert len(jax.devices()) == 8
mesh = make_mesh(8)

def put(name):
    arr = jnp.asarray(np.load(f"{d}/{name}.npy"))
    return jax.device_put(arr, NamedSharding(mesh, P("d")))

np.save(f"{d}/out_ntt_gl.npy", np.asarray(dist_ntt(GL, mesh, put("gl"))))
np.save(f"{d}/out_ntt_fp.npy", np.asarray(dist_ntt(Fp252, mesh, put("fp"))))
np.save(f"{d}/out_lde.npy", np.asarray(
    dist_coset_lde(GL, mesh, put("lde"), 2, GL.GENERATOR)))
np.save(f"{d}/out_step.npy", np.asarray(
    dist_prove_step(GL, mesh, [put(f"col{i}") for i in range(3)])))
print("JAX-MESH-OK")
"""


@pytest.fixture(scope="module")
def jax_mesh_run(tmp_path_factory):
    """Inputs from a numpy seed, and the JAX package's dist_ntt (Goldilocks
    n = 256, Fp252 n = 64), dist_coset_lde (Goldilocks n = 128, blowup 2)
    and dist_prove_step (three Goldilocks columns of 128) on 8 forced CPU
    devices in a subprocess: ({input: numpy array}, {output: numpy
    array})."""
    d = tmp_path_factory.mktemp("jax_mesh")
    rng = np.random.default_rng(2014)
    inputs = {"gl": _words(JGL, rng, (256,)), "fp": _words(JF, rng, (64,)),
              "lde": _words(JGL, rng, (128,))}
    for i in range(3):
        inputs[f"col{i}"] = _words(JGL, rng, (128,))
    for name, arr in inputs.items():
        np.save(d / f"{name}.npy", arr)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    res = subprocess.run([sys.executable, "-c", _JAX_MESH_SCRIPT, str(d)],
                         env=env, capture_output=True, text=True,
                         timeout=900, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "JAX-MESH-OK" in res.stdout
    return inputs, {name: np.load(d / f"out_{name}.npy")
                    for name in ("ntt_gl", "ntt_fp", "lde", "step")}


def test_jax_mesh_dist_ntt_equals_port(jax_mesh_run):
    inputs, outputs = jax_mesh_run
    mesh = make_mesh(8, device="cpu")
    for F, name in ((GL, "gl"), (Fp252, "fp")):
        got = gather(dist_ntt(F, mesh, _port(F, inputs[name])), mesh, CPU)
        assert np.array_equal(_as_jax(F, got), outputs[f"ntt_{name}"])


def test_jax_mesh_dist_coset_lde_equals_port(jax_mesh_run):
    inputs, outputs = jax_mesh_run
    mesh = make_mesh(8, device="cpu")
    got = gather(dist_coset_lde(GL, mesh, _port(GL, inputs["lde"]), 2,
                                GL.GENERATOR), mesh, CPU)
    assert np.array_equal(_as_jax(GL, got), outputs["lde"])


def test_jax_mesh_dist_prove_step_equals_port(jax_mesh_run):
    inputs, outputs = jax_mesh_run
    mesh = make_mesh(8, device="cpu")
    cols = [_port(GL, inputs[f"col{i}"]) for i in range(3)]
    got = gather(dist_prove_step(GL, mesh, cols), mesh, CPU)
    assert got.shape == (256, 8)
    assert np.array_equal(_as_jax(GL, got), outputs["step"])


# -- mesh proves of the tiny claims ------------------------------------------

@pytest.mark.parametrize("D", [4, 8])
@pytest.mark.parametrize("scheme", ["generic", "cairo"])
def test_mesh_prove_equals_pinned_bytes(scheme, D):
    claim, witness = loop_claim(16, CPU, scheme=scheme)
    before = dist.NTT_CALLS
    blob = serialize_proof(claim.prove(witness, TINY,
                                       mesh=make_mesh(D, device="cpu")))
    assert dist.NTT_CALLS > before, "the mesh prove took no four-step NTT"
    with open(os.path.join(ROOT, "tests", "data",
                           f"self_proof_{scheme}.bin"), "rb") as f:
        assert blob == f.read()


@pytest.mark.parametrize("field", ["goldilocks", "gl3"])
def test_mesh_prove_goldilocks_equals_jax_digest(field):
    """The tiny Goldilocks and GF(p^3) claims under a 4-shard mesh give the
    JAX package's digests (its own prove under make_mesh(4) gives them
    too), and the port's verifier accepts them."""
    F = GL if field == "goldilocks" else GL3
    claim, witness = loop_claim(16, CPU, field=F)
    before = dist.NTT_CALLS
    blob = serialize_proof(claim.prove(witness, TINY,
                                       mesh=make_mesh(4, device="cpu")))
    assert dist.NTT_CALLS > before
    assert hashlib.sha256(blob).hexdigest() == TINY_SHA256[field]
    assert claim.verify(parse_proof(blob, modulus=F.MODULUS),
                        required_security_bits=0)


def test_multihost_single_process_semantics():
    """Without a coordinator the multi-process helpers are one-process
    no-ops: initialize is idempotent, this process is the coordinator of a
    grid of one, and the global mesh is make_mesh's."""
    multihost.initialize()
    multihost.initialize()
    assert not torch.distributed.is_initialized()
    assert multihost.is_coordinator()
    assert multihost.process_grid() == (0, 1)
    mesh = multihost.global_mesh(2, device="cpu")
    assert mesh.size == 2 and mesh.world == 1 and mesh.group is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            multihost.global_mesh()


def test_two_process_gloo_prove():
    """Two processes joined by a gloo group (tools/mesh_prove.py: a file
    rendezvous in a temporary directory, no port to collide under
    parallel test workers), two CPU shards each (D = 4), prove the tiny
    generic claim: both give self_proof_generic.bin's bytes and verify
    them."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "MASTER_ADDR", "MASTER_PORT",
                        "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "sandstorm_tpu_torch", "tools",
                                      "mesh_prove.py"),
         "--procs", "2", "--shards", "2", "--device", "cpu",
         "--backend", "gloo", "--steps", "16", "--proves", "1",
         "--timeout", "240"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = [json.loads(ln) for ln in res.stdout.splitlines()
             if ln.startswith("{")]
    workers, last = lines[:-1], lines[-1]
    with open(os.path.join(ROOT, "tests", "data", "self_proof_generic.bin"),
              "rb") as f:
        pinned = hashlib.sha256(f.read()).hexdigest()
    assert [w["rank"] for w in workers] == [0, 1]
    for w in workers:
        assert w["backend"] == "gloo" and w["shards"] == 4
        assert w["dist_ntt_calls_a_prove"] > 0 and w["verified"]
        assert w["proof_sha256"] == pinned
    assert last["ok"] and last["equal"]


# -- the grind's windows ------------------------------------------------------

# seeds of 32-byte prefixes whose first 9-bit hit from nonce 1 lies in
# batch 0, in batch 1 and past a window of two 256-nonce batches
SMALL_BATCH_SEEDS = {"keccak": {0: 101, 1: 104, 2: 100},
                     "blake2s": {0: 100, 1: 101, 2: 102}}


@pytest.mark.parametrize("hash_name", ["keccak", "blake2s"])
def test_grind_window_plain_equals_batch_loop(monkeypatch, hash_name):
    """With batches of 256 nonces and windows of two (the twin's
    granularity; the card runs 2^16 and 64), a window's plain twin returns
    the batch-by-batch loop's first hit, or the window's size when the hit
    lies past it, and grind() returns the loop's nonce, which the host hash
    confirms: the first hit in batch 0, in batch 1 and past the first
    window."""
    monkeypatch.setattr(g, "BATCH", 256)
    monkeypatch.setattr(g, "WINDOW", 2)
    H = keccak256 if hash_name == "keccak" else blake2s256
    bits = 9
    for where, seed in SMALL_BATCH_SEEDS[hash_name].items():
        prefix = np.random.default_rng(seed).bytes(32)
        words = torch.from_numpy(np.frombuffer(prefix, "<u4").view(np.int32)
                                 .copy())
        n0 = 1
        while (idx := g.pow_grind_plain(words, n0, bits, hash_name)) \
                == g.BATCH:
            n0 += g.BATCH
        nonce = n0 + idx
        assert min((nonce - 1) // g.BATCH, 2) == where
        window = g.pow_grind_plain(words, 1, bits, hash_name, batches=2)
        assert window == (nonce - 1 if nonce - 1 < 2 * g.BATCH
                          else 2 * g.BATCH)
        assert g.grind(hash_name, prefix, bits, 1, device=CPU) == nonce
        for k in range(1, nonce + 1):
            lead = int.from_bytes(H(prefix + k.to_bytes(8, "big"))[:4], "big")
            assert (lead >> (32 - bits) == 0) == (k == nonce)


# grind(hash, rng.bytes(32) in turn from default_rng(14), bits, 1) before
# the windows (one 2^16-nonce batch a launch)
NONCES_BEFORE = [("keccak", 8, 213), ("keccak", 12, 550),
                 ("keccak", 16, 54582), ("blake2s", 8, 9),
                 ("blake2s", 12, 2659), ("blake2s", 16, 44986)]


def test_grind_returns_the_nonces_it_returned_before():
    rng = np.random.default_rng(14)
    for hash_name, bits, nonce in NONCES_BEFORE:
        prefix = rng.bytes(32)
        assert g.grind(hash_name, prefix, bits, 1, device=CPU) == nonce
