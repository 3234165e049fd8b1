"""A minimal Cairo machine that generates witnesses (copy of
sandstorm_tpu/runner)."""
