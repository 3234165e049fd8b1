"""Diagnostic tools of the port (ports of the JAX package's tools/)."""
