"""The job generator against the program's own makers: the same instances
from the same draws, and bundles that load to the program's claims with
only the seeded immediate changed."""

import numpy as np
import pytest

from portbench.gen import bundle, instances


@pytest.mark.parametrize("name", ["signatures", "ec_ops", "hash_inputs",
                                  "poseidons", "rc128"])
def test_instance_makers_equal_the_programs(name):
    from sandstorm_tpu_torch import claims
    rng = np.random.default_rng(7)
    if name == "signatures":
        assert instances.signatures(rng, 6) == claims._made_up_signatures(6,
                                                                          7)
    elif name == "ec_ops":
        assert instances.ec_ops(rng, 8) == claims._made_up_ec_ops(8, 7)
    elif name == "hash_inputs":
        assert instances.hash_inputs(rng, 9) == \
            claims._made_up_instances(9, 7)
    elif name == "poseidons":
        assert instances.poseidons(rng, 4) == claims._made_up_poseidons(4, 7)
    else:
        assert instances.rc128(rng, 5, 32766, 32769) == \
            claims._made_up_rc128(5, 7, 32766, 32769)


def test_jacobian_products_equal_the_affine_ones():
    from portbench.reference import curve
    rng = np.random.default_rng(3)
    for _ in range(4):
        k = instances.draw(rng, curve.FR)
        assert instances.ec_mul(k, curve.GENERATOR) == \
            curve.ec_mul(k, curve.GENERATOR)


RECURSIVE = {"layout": "recursive", "n_steps": 16384,
             "builtins": {"pedersen": 3, "bitwise": 3}}


def test_a_job_loads_to_the_programs_claim_but_its_immediate(tmp_path):
    from sandstorm_tpu_torch import claims
    from sandstorm_tpu_torch.examples import load_artifacts
    jobs, _, _ = bundle.make_pool(RECURSIVE, 2 ** 31 + 99, tmp_path, 1)
    program, pub, witness = load_artifacts(
        jobs[0]["program"], jobs[0]["public"], jobs[0]["private"])
    claim, want = claims.recursive_loop_claim(16384, "cpu")
    assert pub.memory_segments["pedersen"].stop_ptr - \
        pub.memory_segments["pedersen"].begin_addr == 9
    for name, seg in claim.public_input.memory_segments.items():
        assert pub.memory_segments[name] == seg
    assert (pub.rc_min, pub.rc_max, pub.n_steps) == (
        claim.public_input.rc_min, claim.public_input.rc_max, 16384)
    assert (witness.register_states.arr == want.register_states.arr).all()
    differ = np.nonzero((witness.memory.values
                         != want.memory.values).any(axis=1))[0]
    assert list(differ) == [2, 6]      # the immediate, and where it is put
    assert program.data[1] == witness.memory.value_int(2) \
        == witness.memory.value_int(6) != 10


def test_the_seed_draws_every_job(tmp_path):
    a, _, _ = bundle.make_pool(RECURSIVE, 5, tmp_path / "a", 2)
    b, _, _ = bundle.make_pool(RECURSIVE, 5, tmp_path / "b", 2)
    c, _, _ = bundle.make_pool(RECURSIVE, 2 ** 33 + 5, tmp_path / "c", 2)
    for key in ("program", "public", "private"):
        text = [open(j[key]).read() for j in a]
        assert text == [open(j[key]).read() for j in b]
        if key != "public":
            assert text[0] != text[1]
            assert text != [open(j[key]).read() for j in c]


def test_too_many_instances_or_a_foreign_builtin_raise(tmp_path):
    with pytest.raises(ValueError):
        bundle.make_pool({**RECURSIVE, "builtins": {"pedersen": 129}},
                         1, tmp_path, 1)
    with pytest.raises(ValueError):
        bundle.make_pool({**RECURSIVE, "builtins": {"ecdsa": 1}}, 1,
                         tmp_path, 1)
