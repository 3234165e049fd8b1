"""Host-side Cairo builtin arithmetic the port needs (the Starkware curve
and the Pedersen hash)."""
