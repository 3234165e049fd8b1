"""Host-side Cairo builtin arithmetic the port needs: the Starkware curve,
the Pedersen hash and builtin witness, and the witnesses of the bitwise,
128-bit range-check, Poseidon, ECDSA and EC-op builtins."""
