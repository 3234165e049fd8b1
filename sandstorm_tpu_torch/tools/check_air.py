"""Which constraint of an AIR fails on a built trace, on one CUDA card.

    python3 sandstorm_tpu_torch/tools/check_air.py [recursive|plain] \\
        [--steps N] [--pedersen K] [--bitwise K] [--device cuda|cpu]

Builds the loop claim of chip_smoke.py's slice for the layout (recursive:
claims.recursive_loop_claim, 16384 steps, with K made-up Pedersen and
bitwise instances; plain: claims.loop_claim, 2^16 steps), its base
columns and its extension columns for random challenges, and checks that
each group of constraints divides out: the group's constraints, folded
with random weights, are evaluated over the LDE domain (evaluate_lde, the
prover's evaluator), interpolated, and the polynomial is evaluated at a
random point x0; the host evaluation of the same constraints at x0
(evaluate_int, the verifier's, over the columns opened at x0 g^k) must
give the same value.  A group that differs is bisected down to its
constraints.  Prints one line per check and exits 1 if any failed.

When a proof of the recursive stand-in fails to verify, run this first,
and again with --pedersen 0 --bitwise 0: a constraint that fails only with
the made-up instances points at the instances' witness, not at the AIR.
"""

import argparse
import random
import sys
import time
from pathlib import Path

# the recursive layout's constraint groups, in the order of its AIR (the
# plain layout's are runs of 8)
RECURSIVE_GROUPS = [
    ("cpu", 0, 27), ("boundary", 27, 33), ("memory", 33, 41),
    ("rc16", 41, 47), ("diluted", 47, 54), ("pedersen", 54, 79),
    ("rc128", 79, 82), ("bitwise", 82, 93)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("layout", nargs="?", default="recursive",
                    choices=["recursive", "plain"])
    ap.add_argument("--steps", type=int)
    ap.add_argument("--pedersen", type=int, default=3)
    ap.add_argument("--bitwise", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch
    from sandstorm_tpu_torch import claims
    from sandstorm_tpu_torch.air.expr import (IntContext, LdeContext,
                                              evaluate_int, evaluate_lde,
                                              trace_arguments)
    from sandstorm_tpu_torch.ntt import coset_powers, intt
    from sandstorm_tpu_torch.stark.openings import open_columns
    from sandstorm_tpu_torch.stark.prover import (_DomainCache,
                                                  _lde_and_coeffs)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("check_air: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    if args.layout == "recursive":
        claim, witness = claims.recursive_loop_claim(
            args.steps or 1 << 14, device, pedersen=args.pedersen,
            bitwise=args.bitwise)
    else:
        claim, witness = claims.loop_claim(args.steps or 1 << 16, device)
    trace = claim.generate_trace(witness)
    F, air, pub = claim.F, claim.air_config, claim.public_input
    p = F.MODULUS
    n = trace.trace_len
    blowup = 2
    N = n * blowup
    coset = F.GENERATOR
    g = F.root_of_unity_int(n)
    rng = random.Random(1234)
    challenges = [rng.randrange(1, p) for _ in range(air.NUM_CHALLENGES)]
    hints = air.gen_hints(n, pub, challenges, p)
    cols = {**trace.base_columns(),
            **trace.build_extension_columns(challenges)}
    coeffs, ldes = _lde_and_coeffs(F, cols, blowup, coset)
    del cols
    print(f"{args.layout}: trace of {n} rows built and extended in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    constraints = air.constraints(n, p, g)
    periodic = (air.periodic_columns(n)
                if hasattr(air, "periodic_columns") else [])
    x0 = rng.randrange(1, p)
    openings, _ = open_columns(F, coeffs, trace_arguments(constraints),
                               x0, g, n)
    del coeffs
    host = evaluate_int(constraints, IntContext(
        p, x0, openings, challenges, hints,
        [pc.eval_int(x0, p) for pc in periodic]))
    dom = _DomainCache(F, N, coset, device)
    unshift = coset_powers(F, pow(coset, -1, p), N, device)

    def divides_out(idxs):
        """Whether the weighted sum of constraints `idxs`, evaluated over
        the LDE domain and interpolated, takes its host value at x0."""
        weights = [rng.randrange(1, p) for _ in idxs]
        ctx = LdeContext(
            F, ldes, blowup, dom.domain, dom.x_pow,
            challenges=[F.encode_int(c, device) for c in challenges],
            hints=[F.encode_int(h, device) for h in hints],
            periodic=[pc.lde_fn(F, dom) for pc in periodic])

        def fold(acc, v, k):
            term = F.mul(v, F.encode_int(weights[k], device))
            return term if acc is None else F.add(acc, term)

        comb = evaluate_lde([constraints[i] for i in idxs], ctx, N,
                            fold=fold)
        poly = F.mul(intt(F, comb), unshift)
        got = open_columns(F, {0: poly}, [(0, 0)], x0, 1, N)[0][(0, 0)]
        return got == sum(w * host[i] for w, i in zip(weights, idxs)) % p

    def check(idxs, label):
        t = time.perf_counter()
        ok = divides_out(idxs)
        print(f"{label}: {'ok' if ok else 'MISMATCH'} ({len(idxs)} "
              f"constraints, {time.perf_counter() - t:.2f} s)", flush=True)
        return ok

    groups = RECURSIVE_GROUPS if args.layout == "recursive" else [
        (f"constraints {lo}-{min(lo + 8, len(constraints)) - 1}", lo,
         min(lo + 8, len(constraints)))
        for lo in range(0, len(constraints), 8)]
    assert [i for _, lo, hi in groups for i in range(lo, hi)] == \
        list(range(len(constraints)))
    failed = []

    def bisect(idxs, label):
        if check(idxs, label):
            return
        if len(idxs) == 1:
            failed.append(idxs[0])
            return
        half = len(idxs) // 2
        for part in (idxs[:half], idxs[half:]):
            bisect(part, f"  constraints {part[0]}-{part[-1]}")

    for name, lo, hi in groups:
        bisect(list(range(lo, hi)), name)
    if failed:
        print(f"FAILED constraints: {failed}", flush=True)
        return 1
    print(f"all {len(constraints)} {args.layout} constraints divide out",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
