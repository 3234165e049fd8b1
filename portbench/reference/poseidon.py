"""StarkWare's poseidon3 parameters, which the starknet layout's periodic
columns interpolate: a copy of the port's builtins/data/poseidon_params.json
in data/, with the optimized partial-round keys of the CryptoExperts
variant."""

import functools
import json
import os

_DATA = os.path.join(os.path.dirname(__file__), "data",
                     "poseidon_params.json")


@functools.lru_cache(maxsize=1)
def params():
    with open(_DATA) as f:
        return json.load(f)


def optimized_partial_round_keys():
    return params()["PARTIAL_ROUND_KEYS_OPTIMIZED"]
