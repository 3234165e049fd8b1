"""FRI low-degree proof: folding on the device, per-query checks on the host
(port of sandstorm_tpu/stark/fri.py).

With P(x) = sum_j x^j Q_j(x^f), layer rows are the cosets {x_i * mu^t}
(mu the order-f root).  The fold is StarkWare's unnormalized one: each
binary halving computes (P(x) + P(-x)) + (beta / x)(P(x) - P(-x)) without
dividing by 2, so one f = 8 fold is 8x the interpolated value.

Layer l lives on the coset c^(f^l) * <w_N^(f^l)>.  Commitments use the
bit-reversed storage order: leaf b of a size-N_l layer holds the f coset
values of natural coset index rev(b), slot t holding the mu^rev(t) member.
A drawn query index is a stored index; it collapses q -> q // f per layer.
"""

import numpy as np
import torch

from .. import _tables
from ..ntt import intt, powers_dev


def fri_fold_device(F, evals, coset: int, layer_size: int, f: int,
                    beta_int: int):
    """One FRI fold of [N, L] natural-order evaluations -> [N/f, L]: log2 f
    unnormalized halvings with beta, beta^2, beta^4, ...  Halving s pairs
    index i with i + half (x and -x):
        out[i] = (f(x) + f(-x)) + beta_s / x * (f(x) - f(-x))
    with 1/x_i = coset^(-2^s) * w^(-(2^s) i)."""
    p = F.BASE_MODULUS
    N = layer_size
    assert evals.shape[0] == N
    stages = f.bit_length() - 1
    assert 1 << stages == f
    w_inv = pow(F.root_of_unity_int(N), -1, p)
    device = evals.device
    xinv = _tables.device_table(f"fri_xinv:{F.NAME}", N // 2, device,
                                lambda: powers_dev(F, w_inv, N // 2, device))
    c_inv = pow(coset, -1, p)
    bs = F.s(beta_int)
    cur = evals
    for s in range(stages):
        half = cur.shape[0] // 2
        top, bot = cur[:half], cur[half:]
        scal = F.encode_int((bs ** (1 << s)) * pow(c_inv, 1 << s, p), device)
        binv = F.mul(xinv[::1 << s][:half], scal)
        cur = F.add(F.add(top, bot), F.mul(F.sub(top, bot), binv))
    return cur


def fri_fold_host(p: int, row, i: int, layer_size: int, coset: int,
                  w: int, f: int, beta: int) -> int:
    """Verifier-side fold of one committed row (python ints): row holds the
    f values [P(x_i mu^t)]_t at reduced index i of the layer."""
    mu_inv = pow(w, -(layer_size // f), p)
    x_inv = pow(coset * pow(w, i, p) % p, -1, p)
    acc = 0
    bx = beta * x_inv % p
    for j in range(f - 1, -1, -1):
        q_j = sum(pow(mu_inv, t * j, p) * row[t] for t in range(f)) % p
        acc = (acc * bx + q_j) % p
    return acc


def bitrev_perm(n: int):
    """perm[b] = bit-reverse of b over log2(n) bits."""
    from ..ntt import bit_reverse_perm
    return bit_reverse_perm(n).astype(np.int64)


def bitrev_int(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def layer_rows(evals, f: int):
    """[N, L] natural-order evals -> [N/f, f, L] rows in the bit-reversed
    leaf order: row b slot t = P(coset * w^bitrev(f*b+t))."""
    N, L = evals.shape
    rows = evals.reshape(f, N // f, L).transpose(0, 1)
    dev = evals.device
    rows = rows[torch.from_numpy(bitrev_perm(N // f)).to(dev)]
    return rows[:, torch.from_numpy(bitrev_perm(f)).to(dev)]


class FriProver:
    """Drives commit-then-fold layers; the transcript lives in the caller."""

    def __init__(self, F, options, domain_size: int, coset: int, scheme):
        self.F = F
        self.options = options
        self.N0 = domain_size
        self.coset0 = coset
        self.scheme = scheme
        self.layers = []        # (tree, rows, layer_size, coset) per layer
        self.remainder = None   # python ints (coefficients)

    def num_layers(self):
        """Layer sizes: fold while the degree bound exceeds
        fri_max_remainder_coeffs."""
        sizes = []
        N = self.N0
        f = self.options.fri_folding_factor
        b = self.options.lde_blowup_factor
        while N // b > self.options.fri_max_remainder_coeffs and N >= f:
            sizes.append(N)
            N //= f
        return sizes

    def commit_layer(self, evals, layer_size, coset):
        f = self.options.fri_folding_factor
        rows = layer_rows(evals, f)  # [N/f, f, L] bit-reversed leaf order
        # the f coset values of a row hash as one concatenated row
        tree = self.scheme.commit(self.F, [rows[:, t] for t in range(f)])
        self.layers.append((tree, rows, layer_size, coset))
        return tree.root

    def fold(self, evals, layer_size, coset, beta_int):
        return fri_fold_device(self.F, evals, coset, layer_size,
                               self.options.fri_folding_factor, beta_int)

    def finalize_remainder(self, evals, layer_size, coset):
        """Interpolate the last layer into remainder coefficients, over the
        offset-free domain (value at natural index j is R(w^j))."""
        ints = self.F.decode_ints(intt(self.F, evals))
        bound = layer_size // self.options.lde_blowup_factor
        assert all(v == 0 for v in ints[bound:]), \
            "FRI remainder has degree above the bound"
        self.remainder = ints[:bound]
        return self.remainder

    def open_ark_plan(self, indices, plan):
        """Queue every layer's row gather and tree sibling gather on `plan`
        (merkle.FetchPlan); returns finish(results) -> [(values, views)]
        per layer: values and MerkleViews per sorted unique folded leaf."""
        from .ark import MerkleView
        F = self.F
        f = self.options.fri_folding_factor
        cur = sorted({int(i) for i in indices})
        metas = []
        for tree, rows, layer_size, coset in self.layers:
            leaves = sorted({i // f for i in cur})
            idx = torch.tensor(leaves, dtype=torch.int64, device=rows.device)
            h = plan.add(F.from_mont(rows[idx]))
            metas.append((leaves, h, tree.plan_paths(leaves, plan)))
            cur = leaves

        def finish(res):
            out = []
            for leaves, h, fin in metas:
                vals = F.decode_np(res[h])
                paths = fin(res)
                values, views = [], []
                for bi in range(len(leaves)):
                    row = [int(v) for v in vals[bi]]
                    values.extend(row)
                    views.append(MerkleView(
                        hashed=True, nodes=list(paths[bi][1:]),
                        initial_leaf=paths[bi][0],
                        sibling_leaf=self.scheme.hash_row(F, row)))
                out.append((values, views))
            return out
        return finish
