"""sandstorm_tpu_torch: the PyTorch + CUDA port of sandstorm_tpu.

A second package beside the JAX one, mirroring its layout module for
module.  Field elements are int32 tensors of u32 words (Fp252 [..., 8]
Montgomery limbs, Goldilocks [..., 2], GF(p^3) [..., 6]); a tensor on the
CPU goes through plain PyTorch code, a tensor on a CUDA device through the
hand-written kernels in csrc/ (built with nvcc at first use).  The package
imports nothing of jax or of the JAX package: the host-only modules it
shares with it (binary/, runner/vm.py, coin.py) are copies.

It covers the plain layout, in the 252-bit field under the generic and the
cairo scheme and over Goldilocks or with GF(p^3) challenges under the
generic scheme, and the recursive layout in the 252-bit field:
CairoClaim.prove -> stark/prover.py:prove -> ark proof bytes, and the
matching verifier.
"""
