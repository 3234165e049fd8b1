"""The reference verifier: judges one proof of one job.

verify(proof_bytes, public_input, program_words, scheme, options) raises
Rejected unless the proof is a valid STARK proof of the job's claim at the
job's proof options and at least `required_security_bits`:

- the proof states the job's options, and they reach the security asked
  for (queries * log2(blowup) + grinding bits, capped by the 80-bit
  collision resistance of both schemes' 20-byte digests);
- the public memory holds the job's program words;
- the transcript replays from the public input (the coin seeded with the
  verifiers' public-input stream), and the stored nonce meets the
  proof-of-work bits;
- the constraints of the layout, evaluated at the OODS point from the
  opened trace values, equal the opened composition columns;
- every queried row of the base, extension and composition traces and of
  each FRI layer opens to its commitment (batched Keccak for the eth
  scheme, Blake2s and Pedersen for the cairo scheme);
- the DEEP composition of each queried row folds through every FRI layer
  to the remainder polynomial.

This follows the port's stark/verifier.py step by step (its geometry:
codewords stored bit-reversed, stored index q at coset * w^bitrev(q),
unnormalized folds, MerkleView.initial_leaf the sibling leaf).
"""

import math
import struct

from .aux_input import CairoAuxInput
from .coins import CairoCoin, SolidityCoin
from .expr import IntContext, evaluate_int, trace_arguments
from .field import Fp252, batch_inv
from .hashes import (blake2s256, canonical_keccak_elements, keccak256,
                     keccak256_many, keep_first, keep_last, mont_elements,
                     pedersen_elements, to_montgomery_bytes)
from .layouts.plain.air import PlainAirConfig
from .layouts.recursive.air import RecursiveAirConfig
from .layouts.starknet.air import StarknetAirConfig
from .pedersen import pedersen_hash
from .proof import ProofFormatError, parse_proof

LAYOUTS = {"plain": PlainAirConfig, "recursive": RecursiveAirConfig,
           "starknet": StarknetAirConfig}
# 20-byte masked digests in both schemes: 80-bit collision resistance
COLLISION_RESISTANCE_BITS = 80
N_FRIENDLY_LAYERS = 22   # the cairo scheme's Pedersen layers (claims.rs:10)
OPTION_NAMES = ("num_queries", "lde_blowup_factor", "proof_of_work_bits",
                "fri_folding_factor", "fri_max_remainder_coeffs")


class Rejected(Exception):
    pass


def _check(cond, msg):
    if not cond:
        raise Rejected(msg)


def security_bits(options: dict) -> int:
    bits = int(options["num_queries"]
               * math.log2(options["lde_blowup_factor"])
               + options["proof_of_work_bits"])
    return min(bits, Fp252.MODULUS.bit_length(), COLLISION_RESISTANCE_BITS)


# -- the two schemes' coins and trees ----------------------------------------

class _CanonicalKeccak:
    hash_elements = staticmethod(canonical_keccak_elements)


class _Pedersen:
    hash_elements = staticmethod(pedersen_elements)


def make_coin(scheme: str, pub):
    if scheme == "eth":
        return SolidityCoin(keccak256(
            CairoAuxInput(pub).serialize(_CanonicalKeccak)))
    if scheme == "cairo":
        return CairoCoin(blake2s256(CairoAuxInput(pub).serialize(_Pedersen)))
    raise ValueError(f"no reference for the {scheme!r} scheme")


def _as32(leaf) -> bytes:
    return leaf if isinstance(leaf, bytes) else int(leaf).to_bytes(32, "big")


def _row_digest(scheme, row):
    """A committed row's leaf digest in its wire form: the raw felt (big
    endian) for a one-column tree, else the masked row hash."""
    if len(row) == 1:
        return int(row[0]).to_bytes(32, "big")
    if scheme == "eth":
        return keep_first(keccak256(mont_elements(row)))
    return keep_last(blake2s256(mont_elements(row)))


def _eth_paths(root, items, height):
    """items: (index, row, path) of one tree.  Every path climbs one level at
    a time, the level's merges hashed in one batch."""
    nodes = []
    for _, row, _ in items:
        nodes.append(to_montgomery_bytes(int(row[0])) if len(row) == 1
                     else None)
    hashed = [k for k, n in enumerate(nodes) if n is None]
    if hashed:
        digests = keccak256_many([mont_elements(items[k][1])
                                  for k in hashed])
        for k, d in zip(hashed, digests):
            nodes[k] = keep_first(d)
    for lvl in range(height):
        msgs = []
        for (idx, _, path), node in zip(items, nodes):
            sib = path[lvl]
            msgs.append(sib + node if (idx >> lvl) & 1 else node + sib)
        nodes = [keep_first(d) for d in keccak256_many(msgs)]
    for (idx, _, _), node in zip(items, nodes):
        _check(node == root, f"root mismatch at index {idx}")


def _cairo_paths(root, items, height, memo):
    """The friendly tree: Blake2s rows and low layers, Pedersen over the top
    N_FRIENDLY_LAYERS (a one-column tree: Pedersen on every level)."""
    def ped(a, b):
        key = (a, b)
        got = memo.get(key)
        if got is None:
            got = memo[key] = pedersen_hash(a, b)
        return got

    def tag(depth, single, raw):
        if single or (depth < height and depth < N_FRIENDLY_LAYERS):
            return ("high", int.from_bytes(raw, "big"))
        return ("low", raw)

    for idx, row, path in items:
        single = len(row) == 1
        troot = tag(0, single, root)
        node = ("high", int(row[0])) if single else \
            ("low", keep_last(blake2s256(mont_elements(row))))
        i = idx
        for lvl, raw in enumerate(path):
            sib = tag(height - lvl, single, raw)
            depth = height - 1 - lvl
            a, b = (sib, node) if i & 1 else (node, sib)
            if single or depth < N_FRIENDLY_LAYERS:
                av = int.from_bytes(a[1], "big") if a[0] == "low" else a[1]
                bv = int.from_bytes(b[1], "big") if b[0] == "low" else b[1]
                node = ("high", ped(av, bv))
            else:
                node = ("low", keep_last(blake2s256(a[1] + b[1])))
            i >>= 1
        _check(node == troot, f"root mismatch at index {idx}")


def _check_tree(scheme, root, num_leaves, views, rows, indices, label, memo):
    height = num_leaves.bit_length() - 1
    items = []
    for idx, view, row in zip(indices, views, rows):
        _check(len(view.nodes) == max(height - 1, 0),
               f"{label}: path length {len(view.nodes)} != {height - 1}")
        if view.hashed:
            _check(_as32(view.sibling_leaf) == _row_digest(scheme, row),
                   f"{label}: leaf of index {idx} does not match its row")
        else:
            _check(len(row) == 1 and view.sibling_leaf == row[0],
                   f"{label}: unhashed leaf of index {idx} does not match")
        path = [_as32(view.initial_leaf)] + [_as32(nd) for nd in view.nodes]
        items.append((idx, list(row), path))
    try:
        if scheme == "eth":
            _eth_paths(root, items, height)
        else:
            _cairo_paths(root, items, height, memo)
    except Rejected as e:
        raise Rejected(f"{label}: {e}") from None


# -- FRI geometry ---------------------------------------------------------------

def bitrev_int(i: int, bits: int) -> int:
    out = 0
    for _ in range(bits):
        out = (out << 1) | (i & 1)
        i >>= 1
    return out


def fri_fold_host(p: int, row, i: int, layer_size: int, coset: int,
                  w: int, f: int, beta: int) -> int:
    """The fold of one committed row (python ints): row holds the f values
    [P(x_i mu^t)]_t at reduced index i of the layer (the port's
    stark/fri.py fri_fold_host)."""
    mu_inv = pow(w, -(layer_size // f), p)
    x_inv = pow(coset * pow(w, i, p) % p, -1, p)
    acc = 0
    bx = beta * x_inv % p
    for j in range(f - 1, -1, -1):
        q_j = sum(pow(mu_inv, t * j, p) * row[t] for t in range(f)) % p
        acc = (acc * bx + q_j) % p
    return acc


# -- the verifier -----------------------------------------------------------------

def replay(scheme, air, pub, proof):
    """Every draw of the transcript, the prover's event schedule (the port's
    stark/transcript_replay.py)."""
    q, blowup = proof.options[0], proof.options[1]
    pow_bits = proof.options[2]
    N = proof.trace_len * blowup
    coin = make_coin(scheme, pub)
    out = {}
    coin.reseed_with_bytes(proof.base_commitment)
    out["challenges"] = [coin.draw_felt() for _ in range(air.NUM_CHALLENGES)]
    if proof.ext_commitment is not None:
        coin.reseed_with_bytes(proof.ext_commitment)
    out["alpha_comp"] = coin.draw_felt()
    coin.reseed_with_bytes(proof.comp_commitment)
    out["z"] = coin.draw_felt()
    coin.reseed_with_felt_vector(list(proof.execution_ood_evals)
                                 + list(proof.composition_ood_evals))
    out["alpha_deep"] = coin.draw_felt()
    betas = []
    for layer in proof.fri_layers:
        coin.reseed_with_bytes(layer.commitment)
        betas.append(coin.draw_felt())
    out["betas"] = betas
    coin.reseed_with_felt_vector(proof.fri_remainder)
    _check(coin.proof_of_work_ok(proof.pow_nonce, pow_bits),
           "the stored nonce fails the proof of work")
    coin.reseed_with_int(proof.pow_nonce)
    out["queries"] = coin.draw_queries(q, N)
    return out


def verify(proof_bytes: bytes, pub, program, scheme: str, options: dict,
           required_security_bits: int = 80):
    """Raise Rejected unless proof_bytes prove the job (public input `pub`,
    program words `program`) under `scheme` at `options`."""
    try:
        proof = parse_proof(proof_bytes)
    except (ProofFormatError, IndexError, struct.error) as e:
        raise Rejected(f"malformed proof: {e}") from None
    stated = dict(zip(OPTION_NAMES, proof.options))
    _check(stated == {k: options[k] for k in OPTION_NAMES},
           f"the proof states options {stated}, the job asked for "
           f"{ {k: options[k] for k in OPTION_NAMES} }")
    _check(security_bits(stated) >= required_security_bits,
           f"{security_bits(stated)} bits of security, "
           f"{required_security_bits} asked for")
    public = {e.address: e.value for e in pub.public_memory}
    _check(all(public.get(a + 1) == w for a, w in enumerate(program)),
           "the public memory does not hold the job's program")
    air = LAYOUTS[pub.layout.value]
    F = Fp252
    p = F.MODULUS
    q, blowup, pow_bits, f, max_rem = proof.options
    n = proof.trace_len
    _check(n == pub.n_steps * air.CYCLE_HEIGHT,
           "trace length inconsistent with the public input")
    _check(f >= 2 and f & (f - 1) == 0 and blowup & (blowup - 1) == 0,
           "folding factor or blowup not a power of two")
    N = n * blowup
    kN = N.bit_length() - 1
    logf = f.bit_length() - 1
    coset = F.GENERATOR
    g = F.root_of_unity_int(n)
    w_N = F.root_of_unity_int(N)
    m = air.CE_BLOWUP_FACTOR

    rt = replay(scheme, air, pub, proof)
    z, alpha_deep, betas = rt["z"], rt["alpha_deep"], rt["betas"]
    indices = rt["queries"]
    _check(len(proof.fri_remainder) <= max_rem, "FRI remainder too large")

    # -- the OODS constraint identity
    constraints = air.constraints(n, p, g, base_modulus=p)
    targs = trace_arguments(constraints)
    _check(len(targs) == len(proof.execution_ood_evals),
           "wrong number of OODS trace values")
    _check(m == len(proof.composition_ood_evals),
           "wrong number of OODS composition values")
    hints = air.gen_hints(n, pub, rt["challenges"], p)
    periodic = (air.periodic_columns(n)
                if hasattr(air, "periodic_columns") else [])
    ctx = IntContext(p, z, dict(zip(targs, proof.execution_ood_evals)),
                     rt["challenges"], hints,
                     [pc.eval_int(z, p) for pc in periodic])
    cvals = evaluate_int(constraints, ctx)
    comp_at_z = cvals[-1]
    for cv in reversed(cvals[:-1]):
        comp_at_z = (comp_at_z * rt["alpha_comp"] + cv) % p
    claimed = 0
    for v in reversed(proof.composition_ood_evals):
        claimed = (claimed * z + v) % p
    _check(comp_at_z == claimed, "OODS constraint identity failed")

    # -- the queried rows and their openings
    num_base = air.NUM_BASE_COLUMNS
    num_ext = air.NUM_EXTENSION_COLUMNS
    Q = len(indices)
    qs = proof.queries
    _check(len(qs.base_values) == Q * num_base, "base values length")
    _check(len(qs.ext_values) == Q * num_ext, "ext values length")
    _check(len(qs.comp_values) == Q * m, "composition values length")
    _check(len(qs.base_proofs) == Q and len(qs.comp_proofs) == Q,
           "trace proof count")
    _check(num_ext == 0 or len(qs.ext_proofs) == Q, "ext proof count")
    _check(num_ext == 0 or proof.ext_commitment is not None,
           "missing extension trace commitment")

    def rows_of(vals, width):
        return [vals[i * width:(i + 1) * width] for i in range(Q)]

    base_rows = rows_of(qs.base_values, num_base)
    ext_rows = rows_of(qs.ext_values, num_ext)
    comp_rows = rows_of(qs.comp_values, m)
    memo = {}
    _check_tree(scheme, proof.base_commitment, N, qs.base_proofs, base_rows,
                indices, "base tree", memo)
    if num_ext:
        _check_tree(scheme, proof.ext_commitment, N, qs.ext_proofs,
                    ext_rows, indices, "extension tree", memo)
    _check_tree(scheme, proof.comp_commitment, N, qs.comp_proofs, comp_rows,
                indices, "composition tree", memo)

    layer_sizes = []
    Nl = N
    while Nl // blowup > max_rem and Nl >= f:
        layer_sizes.append(Nl)
        Nl //= f
    _check(len(layer_sizes) == len(proof.fri_layers), "FRI layer count")
    leaf_sets = []
    cur = list(indices)
    for _ in layer_sizes:
        cur = sorted({i // f for i in cur})
        leaf_sets.append(cur)
    for li, (layer, leaves) in enumerate(zip(proof.fri_layers, leaf_sets)):
        _check(len(layer.values) == len(leaves) * f,
               f"FRI layer {li} values length")
        _check(len(layer.proofs) == len(leaves),
               f"FRI layer {li} proof count")
        _check_tree(scheme, layer.commitment, layer_sizes[li] // f,
                    layer.proofs, [layer.values[k * f:(k + 1) * f]
                                   for k in range(len(leaves))],
                    leaves, f"FRI layer {li}", memo)

    # -- DEEP, then the FRI walk, a query at a time
    offsets = sorted({off for (_, off) in targs})
    z_m = pow(z, m, p)
    points = [z * pow(g, off % n, p) % p for off in offsets]
    xs = [coset * pow(w_N, bitrev_int(idx, kN), p) % p for idx in indices]
    K1 = len(points) + 1
    invs = batch_inv([(x - pt) % p for x in xs for pt in points + [z_m]])
    _check(all(invs), "a query point meets an OODS point")
    col_of = {off: k for k, off in enumerate(offsets)}
    for pos, idx in enumerate(indices):
        row = base_rows[pos] + ext_rows[pos]
        pt_inv = invs[pos * K1:(pos + 1) * K1]
        deep = 0
        coeff = 1
        for j, (col, off) in enumerate(targs):
            deep = (deep + coeff * (row[col] - proof.execution_ood_evals[j])
                    * pt_inv[col_of[off]]) % p
            coeff = coeff * alpha_deep % p
        for l in range(m):
            deep = (deep + coeff * (comp_rows[pos][l]
                                    - proof.composition_ood_evals[l])
                    * pt_inv[-1]) % p
            coeff = coeff * alpha_deep % p
        cur_val, cur_idx, layer_coset = deep, idx, coset
        for li, layer_size in enumerate(layer_sizes):
            half = layer_size // f
            b, t_pos = divmod(cur_idx, f)
            lpos = leaf_sets[li].index(b)
            vals = proof.fri_layers[li].values[lpos * f:(lpos + 1) * f]
            _check(vals[t_pos] == cur_val,
                   f"FRI layer {li} value mismatch at query {idx}")
            row_nat = [vals[bitrev_int(t, logf)] for t in range(f)]
            cur_val = fri_fold_host(p, row_nat,
                                    bitrev_int(b, half.bit_length() - 1),
                                    layer_size, layer_coset,
                                    F.root_of_unity_int(layer_size), f,
                                    betas[li])
            cur_idx = b
            layer_coset = pow(layer_coset, f, p)
        last = layer_sizes[-1] // f if layer_sizes else N
        y = pow(F.root_of_unity_int(last),
                bitrev_int(cur_idx, last.bit_length() - 1), p)
        rem = 0
        for c in reversed(proof.fri_remainder):
            rem = (rem * y + c) % p
        _check(rem == cur_val, f"FRI remainder mismatch at query {idx}")
