"""Mean over the window's proofs of the benchmark's own host clock around
the bundle's load (load_artifacts) and the claim's construction."""


def read(record):
    proofs = record["window"]["proofs"]
    return sum(p["load_s"] for p in proofs) / len(proofs)
