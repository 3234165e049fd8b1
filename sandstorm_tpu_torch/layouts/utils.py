"""Shared layout helpers (port of the parts of sandstorm_tpu/layouts/utils.py
that the plain layout uses)."""


def compute_public_memory_quotient(z, alpha, trace_len, public_memory,
                                   padding_entry, public_memory_step, p):
    """z^S / (prod_i (z - (a_i + alpha v_i)) * pad^(S - N))."""
    s = trace_len // public_memory_step
    numerator = pow(z, s, p)
    denominator = 1
    for e in public_memory:
        denominator = denominator * (z - (e.address + alpha * e.value)) % p
    padding = pow(z - (padding_entry.address + alpha * padding_entry.value) % p,
                  s - len(public_memory), p)
    return numerator * pow(denominator * padding % p, p - 2, p) % p


def upload_base_columns(F, cols_dict, device):
    """Canonical base columns (dict idx -> numpy [n, 4] uint64 LE words) ->
    dict idx -> [n, L] tensors in F's encoding on `device`, in one upload."""
    keys = sorted(cols_dict)
    return dict(zip(keys, F.encode_canonical_u64_many(
        [cols_dict[i] for i in keys], device)))
