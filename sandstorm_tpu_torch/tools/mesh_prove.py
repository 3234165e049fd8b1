"""Prove the recursive stand-in under a mesh of several processes.

    python3 sandstorm_tpu_torch/tools/mesh_prove.py [--procs 2] \\
        [--backend nccl|gloo] [--shards 1] [--device cuda|cpu] \\
        [--steps 16384] [--proves 2]

Starts `--procs` processes joined by a file rendezvous in a temporary
directory (parallel.multihost.initialize), each holding `--shards`
shards of one mesh on its device (cuda:rank % cards, or the CPU with
--device cpu; the backend defaults to NCCL on a card), and each proves
claims.recursive_loop_claim(--steps) under the cairo scheme at the
default ProofOptions `--proves` times under that mesh (with
--steps 16 the tiny plain claim under the generic scheme, 4 queries, 4
bits), then verifies the proof on its host.  With --procs 1 the one
process proves under parallel.make_mesh: one shard on each of the
visible cards (--shards 0, the default there), or --shards virtual
shards on cuda:0.

Each process prints one JSON line (rank, device, backend, shards,
dist_ntt calls, each prove's seconds, the peak device memory, the
proof's sha256, verified); the parent prints them in rank order and one
line last: {"ok": ..., "equal": the processes' sha256 agree}.  It exits
non-zero if a process fails.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _worker(args) -> int:
    import torch
    sys.path.insert(0, str(ROOT))
    from sandstorm_tpu_torch.parallel import multihost
    if args.procs > 1:
        multihost.initialize(args.rendezvous, args.procs, args.rank,
                             backend=args.backend)
    from sandstorm_tpu_torch import claims
    from sandstorm_tpu_torch.parallel import dist, make_mesh
    from sandstorm_tpu_torch.stark.ark import parse_proof, serialize_proof
    from sandstorm_tpu_torch.stark.options import ProofOptions
    if args.procs > 1:
        device = None if args.device == "cuda" else args.device
        mesh = multihost.global_mesh(args.shards or 1, device=device)
    elif args.device == "cpu" or args.shards:
        mesh = make_mesh(args.shards or 1,
                         device="cuda:0" if args.device == "cuda" else "cpu")
    else:
        mesh = make_mesh()
    dev = mesh.devices[0]
    if args.steps == 16:
        claim, witness = claims.loop_claim(16, dev)
        options = ProofOptions(num_queries=4, proof_of_work_bits=4)
        bits = 0
    else:
        claim, witness = claims.recursive_loop_claim(args.steps, dev)
        options, bits = ProofOptions(), 80

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    prove_s, blob = [], None
    calls = dist.NTT_CALLS
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(args.proves):
        sync()
        t0 = time.perf_counter()
        proof = claim.prove(witness, options, mesh=mesh)
        sync()
        prove_s.append(time.perf_counter() - t0)
        got = serialize_proof(proof)
        if blob is not None and got != blob:
            raise RuntimeError("two proves of one claim differ")
        blob = got
    t0 = time.perf_counter()
    verified = claim.verify(parse_proof(blob), required_security_bits=bits)
    verify_s = time.perf_counter() - t0
    print(json.dumps({
        "rank": args.rank, "procs": args.procs, "device": str(dev),
        "backend": (torch.distributed.get_backend() if args.procs > 1
                    else None),
        "shards": mesh.size,
        "dist_ntt_calls_a_prove": (dist.NTT_CALLS - calls) / args.proves,
        "prove_s": prove_s, "verify_s": verify_s,
        "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None),
        "proof_bytes": len(blob),
        "proof_sha256": hashlib.sha256(blob).hexdigest(),
        "verified": bool(verified)}), flush=True)
    if args.procs > 1:
        torch.distributed.destroy_process_group()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--backend", default=None,
                    help="nccl or gloo (default: nccl on a card)")
    ap.add_argument("--shards", type=int, default=0,
                    help="shards a process (default 1; with --procs 1, "
                         "0 takes every card)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=16384)
    ap.add_argument("--proves", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=900)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rendezvous", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        return _worker(args)
    if args.backend is None:
        args.backend = "nccl" if args.device == "cuda" else "gloo"
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK")}
    with tempfile.TemporaryDirectory() as tmp:
        rendezvous = "file://" + os.path.join(tmp, "rendezvous")
        cmd = [sys.executable, str(Path(__file__).resolve()),
               "--procs", str(args.procs), "--backend", args.backend,
               "--shards", str(args.shards), "--device", args.device,
               "--steps", str(args.steps), "--proves", str(args.proves),
               "--rendezvous", rendezvous]
        procs = [subprocess.Popen(cmd + ["--rank", str(rank)], env=env,
                                  cwd=ROOT, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for rank in range(args.procs)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=args.timeout))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    lines, ok = [], True
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        got = [ln for ln in out.splitlines() if ln.startswith("{")]
        if p.returncode != 0 or not got:
            ok = False
            print(f"mesh_prove: rank {rank} exited {p.returncode}:\n"
                  f"{err[-3000:]}", file=sys.stderr)
            continue
        lines.append(json.loads(got[-1]))
        print(got[-1], flush=True)
    equal = ok and len({ln["proof_sha256"] for ln in lines}) == 1
    ok = ok and equal and all(ln["verified"] for ln in lines)
    print(json.dumps({"ok": ok, "equal": equal, "procs": args.procs,
                      "backend": args.backend}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
