"""sandstorm_tpu_torch: the PyTorch + CUDA port of sandstorm_tpu.

A second package beside the JAX one, mirroring its layout module for
module.  Field elements are [..., 8] int32 tensors of Montgomery limbs; a
tensor on the CPU goes through plain PyTorch code, a tensor on a CUDA device
through the hand-written kernels in csrc/ (built with nvcc at first use).
The package imports nothing of jax or of the JAX package: the host-only
modules it shares with it (binary/, runner/vm.py, coin.py) are copies.

Slice 1 covers the plain layout under the generic scheme in the 252-bit
field: CairoClaim.prove -> stark/prover.py:prove -> ark proof bytes, and
the matching verifier.
"""
