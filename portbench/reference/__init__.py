"""The benchmark's plain reference: a STARK verifier in python ints and
NumPy that judges the proofs the timed path produced.

It is a frozen copy of the port's host verifier and of what it needs (the
three layouts' constraints, the two verifiers' coins and Merkle trees, the
ark proof parser), kept here so that a later change to the program cannot
move the yardstick.  It imports nothing of the program, of jax or of the
JAX package; it reads the job's own public input and program files and the
proof bytes, and nothing else the program made.
"""
