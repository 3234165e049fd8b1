"""The Cairo-verifier protocol on the host: its hashes, its coin and the
friendly Merkle tree."""
