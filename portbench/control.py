"""Run a cell with a fault planted in the program underneath the harness, to
show that the comparison that decides `correct` catches it.

    python3 portbench/control.py --fault NAME [NAME ...] --workload CELL \\
        --seed N [N ...] --seconds S

runs the cell once for each fault and seed, in one process (the imports
paid once), and prints each run's result line like run.py, whatever
`correct` reads, with the fault and the seed in front.  The faults:

- skip_grind (the control): the proof-of-work nonce is not ground, so a
  proof claims its options' security without the grind's bits: the one
  guarantee the configurations state, 80 bits, is broken;
- flip_byte: one byte of each proof altered where it is produced (the ark
  serialization);
- bad_trace: one cell of the base trace altered where the trace build
  produces it (column 0, row 1, its lowest limb's lowest bit).

The benchmark's own runs plant none of them.
"""

import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def _patched(owner, name, replacement):
    original = getattr(owner, name)
    setattr(owner, name, replacement(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def skip_grind():
    from sandstorm_tpu_torch.crypto import coins
    return _patched(coins._VerifierCoin, "grind_proof_of_work",
                    lambda original: lambda self, bits, device: 0)


def flip_byte():
    from sandstorm_tpu_torch.stark import ark

    def replacement(original):
        def serialize_proof(proof):
            blob = bytearray(original(proof))
            blob[len(blob) // 2] ^= 1
            return bytes(blob)
        return serialize_proof
    return _patched(ark, "serialize_proof", replacement)


def bad_trace():
    from sandstorm_tpu_torch import claims

    def replacement(original):
        def generate_trace(self, witness):
            trace = original(self, witness)
            cols = trace.base_columns()
            cols[min(cols)][1, 0] ^= 1
            return trace
        return generate_trace
    return _patched(claims.CairoClaim, "generate_trace", replacement)


FAULTS = {"skip_grind": skip_grind, "flip_byte": flip_byte,
          "bad_trace": bad_trace}


def main(argv=None) -> int:
    import argparse
    from portbench import run
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fault", required=True, nargs="+",
                    choices=sorted(FAULTS))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True, nargs="+")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    for fault in args.fault:
        for seed in args.seed:
            with FAULTS[fault]():
                result = run.run_cell(run.BENCH_JSON, args.workload, seed,
                                      args.seconds, 0,
                                      torch.device("cuda", 0),
                                      t_process=time.perf_counter())
            for name, c in result["checks"].items():
                print(f"check {fault} {seed} {name} {c['value']} "
                      f"limit {c['limit']}", file=sys.stderr)
            print(json.dumps({"fault": fault, "seed": seed, **result}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
