"""Host-side Cairo artifacts and instruction decode (copy of
sandstorm_tpu/binary, trimmed to what the plain-layout slice reads)."""
