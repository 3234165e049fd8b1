"""Host-side Cairo builtin arithmetic the port needs: the Starkware curve,
the Pedersen hash and builtin witness, and the bitwise builtin."""
