"""Mean over the window's proofs of the benchmark's own host clock around
generate_trace, ending in a device synchronize."""


def read(record):
    proofs = record["window"]["proofs"]
    return sum(p["trace_build_s"] for p in proofs) / len(proofs)
