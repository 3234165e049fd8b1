"""Replay the Fiat–Shamir transcript over a parsed proof, returning every
draw (port of sandstorm_tpu/stark/transcript_replay.py).  The event
sequence is the prover's (stark/prover.py), as PARITY.md's "Fiat–Shamir
event schedule" lists it; stark/verifier.py::verify_ark takes its draws
from here.
"""

from .options import ProofOptions


def replay_transcript(F, air_config, public_input, proof, scheme) -> dict:
    p = F.MODULUS
    q, blowup, pow_bits, f, max_rem = proof.options
    options = ProofOptions(
        num_queries=q, lde_blowup_factor=blowup, proof_of_work_bits=pow_bits,
        fri_folding_factor=f, fri_max_remainder_coeffs=max_rem)
    n = proof.trace_len
    N = n * blowup
    coin = scheme.make_coin(public_input, options, n)
    out = {}
    coin.reseed_with_digest(proof.base_commitment)
    out["challenges"] = [int(c) for c in
                         coin.draw_felts(p, air_config.NUM_CHALLENGES)]
    if proof.ext_commitment is not None:
        coin.reseed_with_digest(proof.ext_commitment)
    out["alpha_comp"] = int(coin.draw_felt(p))
    coin.reseed_with_digest(proof.comp_commitment)
    out["z"] = int(coin.draw_felt(p))
    coin.reseed_with_field_element_vector(
        p, list(proof.execution_ood_evals)
        + list(proof.composition_ood_evals))
    out["alpha_deep"] = int(coin.draw_felt(p))
    betas = []
    for layer in proof.fri_layers:
        coin.reseed_with_digest(layer.commitment)
        betas.append(int(coin.draw_felt(p)))
    out["betas"] = betas
    coin.reseed_with_field_element_vector(p, proof.fri_remainder)
    assert coin.verify_proof_of_work(proof.pow_nonce, pow_bits), \
        "stored PoW nonce fails under the replayed schedule"
    coin.reseed_with_int(proof.pow_nonce)
    out["nonce"] = int(proof.pow_nonce)
    out["queries"] = [int(i) for i in coin.draw_queries(q, N)]
    return out
