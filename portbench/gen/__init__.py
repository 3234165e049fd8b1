"""The benchmark's job generator: cairo-run bundles drawn from a seed."""
