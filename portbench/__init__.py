"""The benchmark of sandstorm_tpu_torch on NVIDIA H100 cards: whole proofs
of cairo-run bundles, one job after another (python3 portbench/run.py)."""
