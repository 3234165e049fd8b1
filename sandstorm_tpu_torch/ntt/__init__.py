from .ntt import (bit_reverse_perm, coset_eval_from_coeffs, coset_powers,
                  intt, ntt, powers_dev, powers_host)

__all__ = ["bit_reverse_perm", "coset_eval_from_coeffs", "coset_powers",
           "intt", "ntt", "powers_dev", "powers_host"]
