"""Command-line interface (port of sandstorm_tpu/cli.py, the reference
CLI's semantics, cli/src/main.rs):

    python -m sandstorm_tpu_torch --program p.json \\
        --air-public-input pub.json [--scheme generic|eth|cairo] \\
        prove --air-private-input priv.json --output proof.bin \\
        [--device cuda] [--num-queries 65] [--lde-blowup-factor 2] \\
        [--proof-of-work-bits 16] [--fri-folding-factor 8] \\
        [--fri-max-remainder-coeffs 16]

    python -m sandstorm_tpu_torch --program p.json \\
        --air-public-input pub.json [--scheme ...] \\
        verify --proof proof.bin [--required-security-bits 80]

The field follows the program's prime (main.rs:83-135): the Starkware
252-bit prime, or Goldilocks with GF(p^3) challenges.  The scheme follows
the layout unless --scheme is given: recursive -> cairo, starknet -> eth,
any other -> generic.  prove runs on --device, a CUDA card unless the
caller asks for the CPU, and raises if that device is missing; verify runs
on the host.
"""

import argparse
import sys
import time

import torch

from .binary.formats import AirPublicInput, CompiledProgram, Layout
from .claims import CairoClaim
from .examples import load_artifacts
from .fields.fp252 import Fp252
from .fields.gl3 import GL3
from .fields.goldilocks import GL
from .stark.ark import parse_proof, serialize_proof
from .stark.options import ProofOptions
from .stark.verifier import VerificationError


def _field_for_prime(prime: int):
    if prime == Fp252.MODULUS:
        return Fp252
    if prime == GL.MODULUS:
        # the reference's Goldilocks dispatch draws its challenges from the
        # cubic extension (main.rs:104-110): trace columns in GL, the
        # transcript, OODS and DEEP in GF(p^3)
        return GL3
    raise SystemExit(f"unsupported field prime: {hex(prime)}")


def scheme_for(layout, F, override=None) -> str:
    """The reference's claim for a layout (main.rs:83-135): a
    Starkware-prime recursive run proves the CairoVerifierClaim, a starknet
    run the EthVerifierClaim, anything else the generic scheme; `override`
    (--scheme) wins."""
    if override:
        return override
    if F is Fp252 and layout == Layout.RECURSIVE:
        return "cairo"
    if F is Fp252 and layout == Layout.STARKNET:
        return "eth"
    return "generic"


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           f"(give --device cpu to prove on the CPU)")
    return device


def main(argv=None):
    parser = argparse.ArgumentParser(prog="sandstorm-tpu-torch")
    parser.add_argument("--program", required=True)
    parser.add_argument("--air-public-input", required=True)
    parser.add_argument("--layout", default=None,
                        help="override the layout (default: the public "
                             "input's)")
    parser.add_argument("--scheme", default=None,
                        choices=["generic", "eth", "cairo"],
                        help="proof scheme: generic (Blake2s Merkle tree + "
                             "the generic coin), eth (EthVerifierClaim: "
                             "masked-Keccak Merkle tree + the Solidity "
                             "coin), cairo (CairoVerifierClaim: friendly "
                             "Merkle tree + the Cairo coin).  Default: from "
                             "the layout, as the reference CLI (recursive -> "
                             "cairo, starknet -> eth, otherwise generic)")
    sub = parser.add_subparsers(dest="command", required=True)

    prove_p = sub.add_parser("prove")
    prove_p.add_argument("--air-private-input", required=True)
    prove_p.add_argument("--output", required=True)
    prove_p.add_argument("--device", default="cuda",
                         help="torch device of the prove (default: cuda)")
    prove_p.add_argument("--num-queries", type=int, default=65)
    prove_p.add_argument("--lde-blowup-factor", type=int, default=2)
    prove_p.add_argument("--proof-of-work-bits", type=int, default=16)
    prove_p.add_argument("--fri-folding-factor", type=int, default=8)
    prove_p.add_argument("--fri-max-remainder-coeffs", type=int, default=16)

    verify_p = sub.add_parser("verify")
    verify_p.add_argument("--proof", required=True)
    verify_p.add_argument("--required-security-bits", type=int, default=80)

    args = parser.parse_args(argv)

    if args.command == "prove":
        device = _device(args.device)
        program, pub, witness = load_artifacts(
            args.program, args.air_public_input, args.air_private_input)
        F = _field_for_prime(program.prime)
        layout = Layout(args.layout) if args.layout else pub.layout
        claim = CairoClaim(program, pub, device=device, field=F,
                           layout=layout,
                           scheme=scheme_for(layout, F, args.scheme))
        options = ProofOptions(
            num_queries=args.num_queries,
            lde_blowup_factor=args.lde_blowup_factor,
            proof_of_work_bits=args.proof_of_work_bits,
            fri_folding_factor=args.fri_folding_factor,
            fri_max_remainder_coeffs=args.fri_max_remainder_coeffs)
        now = time.time()
        proof = claim.prove(witness, options)
        t = time.time() - now
        blob = serialize_proof(proof)
        with open(args.output, "wb") as f:
            f.write(blob)
        print(f"proof generated in {t:.1f}s")
        sec = options.security_level_bits(
            field_bits=F.MODULUS.bit_length(),
            collision_resistance_bits=claim.scheme.COLLISION_RESISTANCE_BITS)
        print(f"proof security (conjectured): {sec}bit")
        print(f"proof size: {len(blob) / 1024:.1f}KB")
        return 0

    program = CompiledProgram.from_json(args.program)
    pub = AirPublicInput.from_json(args.air_public_input)
    F = _field_for_prime(program.prime)
    layout = Layout(args.layout) if args.layout else pub.layout
    claim = CairoClaim(program, pub, device="cpu", field=F, layout=layout,
                       scheme=scheme_for(layout, F, args.scheme))
    now = time.time()
    try:
        with open(args.proof, "rb") as f:
            proof = parse_proof(f.read(), modulus=F.MODULUS)
        claim.verify(proof, args.required_security_bits)
    except (AssertionError, VerificationError) as e:
        # malformed bytes (the parser's asserts) and protocol faults both
        # come out as a rejection, as `sandstorm verify` gives them
        raise SystemExit(f"proof rejected: {e}")
    print(f"proof verified in {time.time() - now:.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
