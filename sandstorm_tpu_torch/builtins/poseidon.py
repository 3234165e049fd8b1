"""The Poseidon builtin: the Hades permutation (m = 3, 8 full and 83
partial rounds, x^3 S-box) with the per-round states the starknet AIR
constrains (copy of sandstorm_tpu/builtins/poseidon.py).

The parameters are StarkWare's poseidon3 constants, read from this
package's own data/poseidon_params.json, with the optimized partial-round
keys of the CryptoExperts variant (the reference sandstorm's
builtins/src/poseidon/params.rs PARTIAL_ROUND_KEYS_OPTIMIZED).
"""

import dataclasses
import functools
import json
import os

from .curve import P

_DATA = os.path.join(os.path.dirname(__file__), "data",
                     "poseidon_params.json")

M = 3
NUM_FULL_ROUNDS = 8
NUM_PARTIAL_ROUNDS = 83
RATE = 2
CAPACITY = 1


@functools.lru_cache(maxsize=1)
def params():
    with open(_DATA) as f:
        return json.load(f)


def mds():
    return params()["MDS"]


def round_keys():
    d = params()
    return (d["FULL_ROUND_KEYS_1ST_HALF"] + d["PARTIAL_ROUND_KEYS"]
            + d["FULL_ROUND_KEYS_2ND_HALF"])


def _mat_vec(mat, v):
    return [sum(mat[i][j] * v[j] for j in range(M)) % P for i in range(M)]


def full_round(state, keys):
    state = [pow((s + k) % P, 3, P) for s, k in zip(state, keys)]
    return _mat_vec(mds(), state)


def partial_round(state, keys):
    state = [(s + k) % P for s, k in zip(state, keys)]
    state[2] = pow(state[2], 3, P)
    return _mat_vec(mds(), state)


def permute(state):
    """The Hades permutation of [s0, s1, s2]."""
    keys = round_keys()
    r = 0
    for _ in range(NUM_FULL_ROUNDS // 2):
        state = full_round(state, keys[r])
        r += 1
    for _ in range(NUM_PARTIAL_ROUNDS):
        state = partial_round(state, keys[r])
        r += 1
    for _ in range(NUM_FULL_ROUNDS // 2):
        state = full_round(state, keys[r])
        r += 1
    return state


def hash_two(a: int, b: int) -> int:
    """poseidon(a, b) by StarkWare's sponge: state (a, b, 2), output s0."""
    return permute([a % P, b % P, 2])[0]


def hades_permutation(s0, s1, s2):
    return permute([s0, s1, s2])


def optimized_partial_round_keys():
    """The one key per partial round of the optimized variant (the
    schedule the starknet AIR constrains)."""
    return params()["PARTIAL_ROUND_KEYS_OPTIMIZED"]


def optimized_2nd_half_first_round_keys():
    """The first round keys of the second full-round half in the optimized
    variant."""
    return params()["FULL_ROUND_KEYS_2ND_HALF_OPTIMIZED_FIRST"]


@dataclasses.dataclass
class FullRoundStates:
    after_add_round_keys: list  # [3]
    after_apply_s_box: list     # [3]
    after_mds_mul: list         # [3]


def gen_half_full_round_states(state, keys_half):
    """The states of each round of one full-round half."""
    rounds = []
    for rks in keys_half:
        state = [(s + k) % P for s, k in zip(state, rks)]
        after_add = list(state)
        state = [pow(s, 3, P) for s in state]
        after_sbox = list(state)
        state = _mat_vec(mds(), state)
        rounds.append(FullRoundStates(after_add, after_sbox, list(state)))
    return rounds


@dataclasses.dataclass
class InstanceTrace:
    """Witness of one Poseidon builtin instance: every round's state in the
    optimized variant."""
    index: int
    input0: int
    input1: int
    input2: int
    output0: int
    output1: int
    output2: int
    full_round_states_1st_half: list   # [4] FullRoundStates
    full_round_states_2nd_half: list   # [4] FullRoundStates
    partial_round_states: list         # [83] states after the round key

    @classmethod
    def new(cls, index: int, input0: int, input1: int, input2: int):
        d = params()
        state = [input0 % P, input1 % P, input2 % P]
        first_half = gen_half_full_round_states(
            state, d["FULL_ROUND_KEYS_1ST_HALF"])
        state = list(first_half[-1].after_mds_mul)

        partial_states = []
        for key in optimized_partial_round_keys():
            state[2] = (state[2] + key) % P
            partial_states.append(state[2])
            state[2] = pow(state[2], 3, P)
            state = _mat_vec(mds(), state)

        keys_2nd = [list(k) for k in d["FULL_ROUND_KEYS_2ND_HALF"]]
        keys_2nd[0] = optimized_2nd_half_first_round_keys()
        second_half = gen_half_full_round_states(state, keys_2nd)
        final_state = second_half[-1].after_mds_mul
        # witness generation asserts that the AIR will pass
        assert final_state == permute([input0, input1, input2])
        return cls(index=index, input0=input0 % P, input1=input1 % P,
                   input2=input2 % P,
                   output0=final_state[0], output1=final_state[1],
                   output2=final_state[2],
                   full_round_states_1st_half=first_half,
                   full_round_states_2nd_half=second_half,
                   partial_round_states=partial_states)

    @classmethod
    def new_dummy(cls, index: int):
        return dataclasses.replace(_dummy_template(), index=index)


@functools.lru_cache(maxsize=1)
def _dummy_template():
    return InstanceTrace.new(0, 0, 0, 0)
