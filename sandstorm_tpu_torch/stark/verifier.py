"""The STARK verifier: host-side python-int math (port of
sandstorm_tpu/stark/verifier.py, generic scheme).

`verify_ark` replays the prover's Fiat-Shamir transcript over an
ark-serialized proof (stark/ark.py) and checks every commitment, the OODS
constraint identity, the DEEP composition and the full FRI walk.

Geometry: codewords are stored bit-reversed and drawn query indices are
stored indices, so the field point of stored index q is
`coset * w^bitrev(q)`; FRI folds are unnormalized (scale f per fold), a
stored index collapses q -> q // f per layer, and the remainder
coefficients are over the offset-free domain.  A MerkleView carries the
sibling leaf (`initial_leaf`) plus the node path above the leaf pair.
"""

from ..air.expr import IntContext, evaluate_int, trace_arguments
from .ark import ArkProof, MerkleView
from .fri import fri_fold_host, bitrev_int
from .options import ProofOptions


class VerificationError(Exception):
    pass


def _check(cond, msg):
    if not cond:
        raise VerificationError(msg)


def verify(F, air_config, public_input, proof,
           required_security_bits: int = 80, scheme=None) -> bool:
    """Verify an ArkProof (raises VerificationError on any defect)."""
    from .scheme import get_scheme
    return verify_ark(F, air_config, public_input, proof, get_scheme(scheme),
                      required_security_bits=required_security_bits)


def _as32(leaf) -> bytes:
    return leaf if isinstance(leaf, bytes) else int(leaf).to_bytes(32, "big")


def _verify_merkle_view(scheme, F, root: bytes, num_leaves: int, index: int,
                        view: MerkleView, row, label: str):
    """Check one MerkleView against a root.

    ministark's serialization stores the *sibling* leaf as `initial_leaf`
    and the queried row's own digest as `sibling_leaf` (field order of the
    struct, recovered byte-level); `nodes` are the sibling digests above
    the leaf pair, leaf-to-root.  The full sibling path is therefore
    [initial_leaf] + nodes, which the scheme's row verifier consumes.
    """
    height = num_leaves.bit_length() - 1
    _check(len(view.nodes) == max(height - 1, 0),
           f"{label}: path length {len(view.nodes)} != {height - 1}")
    if view.hashed:
        _check(_as32(view.sibling_leaf) == scheme.hash_row(F, row),
               f"{label}: leaf does not match row hash")
    else:
        _check(len(row) == 1 and view.sibling_leaf == row[0],
               f"{label}: unhashed leaf does not match value")
    path = [_as32(view.initial_leaf)] + [_as32(nd) for nd in view.nodes]
    _check(scheme.verify_row(F, root, index, list(row), path),
           f"{label}: root mismatch")


def _host_batch_inv(F, vals, p):
    """Montgomery-trick inversion of host field values; 0 -> 0."""
    one = F.s(1)
    pref = []
    acc = one
    for v in vals:
        pref.append(acc)
        if v != 0:
            acc = acc * v % p
    inv = pow(acc, p - 2, p)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        if vals[i] == 0:
            continue
        out[i] = pref[i] * inv % p
        inv = inv * vals[i] % p
    return out


def verify_ark(F, air_config, public_input, proof: ArkProof, scheme,
               required_security_bits: int = 0) -> bool:
    """Verify an ark-serialized proof.  Raises VerificationError."""
    p = F.MODULUS
    q, blowup, pow_bits, f, max_rem = proof.options
    options = ProofOptions(
        num_queries=q, lde_blowup_factor=blowup, proof_of_work_bits=pow_bits,
        fri_folding_factor=f, fri_max_remainder_coeffs=max_rem)
    if required_security_bits:
        sec = options.security_level_bits(
            field_bits=F.MODULUS.bit_length(),
            collision_resistance_bits=getattr(
                scheme, "COLLISION_RESISTANCE_BITS", None))
        _check(sec >= required_security_bits,
               "proof options below required security level")
    pb = F.BASE_MODULUS
    n = proof.trace_len
    _check(n == public_input.n_steps * air_config.CYCLE_HEIGHT,
           "trace length inconsistent with public input")
    N = n * blowup
    kN = N.bit_length() - 1
    logf = f.bit_length() - 1
    coset = F.GENERATOR
    g = F.root_of_unity_int(n)
    w_N = F.root_of_unity_int(N)
    m = air_config.CE_BLOWUP_FACTOR

    # -- transcript: replay the schedule (stark/transcript_replay.py); its
    # PoW assert surfaces as a rejection
    from .transcript_replay import replay_transcript
    try:
        rt = replay_transcript(F, air_config, public_input, proof, scheme)
    except AssertionError as e:
        raise VerificationError(str(e))
    challenges = rt["challenges"]
    alpha_comp = rt["alpha_comp"]
    z = rt["z"]
    alpha_deep = rt["alpha_deep"]
    fri_betas = rt["betas"]
    indices = rt["queries"]
    _check(len(proof.fri_remainder) <= max_rem, "FRI remainder too large")

    # -- OODS constraint identity -------------------------------------------
    constraints = air_config.constraints(n, p, g, base_modulus=pb)
    targs = trace_arguments(constraints)
    _check(len(targs) == len(proof.execution_ood_evals),
           "wrong number of OODS trace values")
    _check(m == len(proof.composition_ood_evals),
           "wrong number of OODS composition values")
    zS = F.s(z)
    hints = air_config.gen_hints(n, public_input,
                                 [F.s(c) for c in challenges], p)
    trace_values = dict(zip(targs, proof.execution_ood_evals))
    periodic_cols = (air_config.periodic_columns(n)
                     if hasattr(air_config, "periodic_columns") else [])
    ctx = IntContext(p, z, trace_values, challenges, hints,
                     [pc.eval_int(zS, p) for pc in periodic_cols], s=F.s)
    cvals = evaluate_int(constraints, ctx)
    acS = F.s(alpha_comp)
    comp_at_z = cvals[-1]
    for cv in reversed(cvals[:-1]):
        comp_at_z = (comp_at_z * acS + cv) % p
    claimed = F.s(0)
    for l in reversed(range(m)):
        claimed = (claimed * zS + F.s(proof.composition_ood_evals[l])) % p
    _check(F.s(comp_at_z) == claimed, "OODS constraint identity failed")

    # -- per-query data (rows stored row-major over sorted query indices) ----
    num_base = air_config.NUM_BASE_COLUMNS
    num_ext = air_config.NUM_EXTENSION_COLUMNS
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

    trees = [(base_rows, qs.base_proofs, proof.base_commitment, "base"),
             (comp_rows, qs.comp_proofs, proof.comp_commitment, "comp")]
    if num_ext:
        trees.insert(1, (ext_rows, qs.ext_proofs, proof.ext_commitment,
                         "ext"))
    for pos, idx in enumerate(indices):
        for rows, proofs, root, label in trees:
            _verify_merkle_view(scheme, F, root, N, idx, proofs[pos],
                                rows[pos], f"{label} tree, query {idx}")

    # -- DEEP + FRI walk per query ------------------------------------------
    offsets = sorted({off for (_, off) in targs})
    z_m = zS ** m
    alphaS = F.s(alpha_deep)
    points = [zS * pow(g, off % n, pb) for off in offsets]

    # FRI layer sizes + per-layer deduped row indices (stored space)
    layer_sizes = []
    Nl = N
    while Nl // blowup > max_rem and Nl >= f:
        layer_sizes.append(Nl)
        Nl //= f
    _check(len(layer_sizes) == len(proof.fri_layers), "FRI layer count")
    layer_leaf_sets = []
    cur = list(indices)
    for size in layer_sizes:
        leaves = sorted({i // f for i in cur})
        layer_leaf_sets.append(leaves)
        cur = leaves
    for li, (layer, leaves) in enumerate(zip(proof.fri_layers,
                                             layer_leaf_sets)):
        _check(len(layer.values) == len(leaves) * f,
               f"FRI layer {li} values length")
        _check(len(layer.proofs) == len(leaves),
               f"FRI layer {li} proof count")
        half = layer_sizes[li] // f
        for lpos, leaf in enumerate(leaves):
            row = layer.values[lpos * f:(lpos + 1) * f]
            _verify_merkle_view(
                scheme, F, layer.commitment, half, leaf, layer.proofs[lpos],
                row, f"FRI layer {li}, leaf {leaf}")

    # all DEEP denominators across every query share ONE Fermat inversion
    # (Montgomery batch trick; the reference batch-inverts per column,
    # layouts' build_extension_columns do the same on the prover side)
    xs = [coset * pow(w_N, bitrev_int(idx, kN), pb) % pb for idx in indices]
    all_dens = [[(x - pt) % p for pt in points] + [(x - z_m) % p]
                for x in xs]
    all_invs = _host_batch_inv(F, [d for row in all_dens for d in row], p)
    K1 = len(points) + 1

    for pos, idx in enumerate(indices):
        x = xs[pos]

        def col_val(col):
            return (base_rows[pos][col] if col < num_base
                    else ext_rows[pos][col - num_base])

        pt_inv = all_invs[pos * K1:(pos + 1) * K1 - 1]
        zm_inv = all_invs[(pos + 1) * K1 - 1]
        deep_val = F.s(0)
        coeff = F.s(1)
        for j, (col, off) in enumerate(targs):
            k = offsets.index(off)
            t = proof.execution_ood_evals[j]
            deep_val = (deep_val + coeff * (F.s(col_val(col)) - F.s(t))
                        * pt_inv[k]) % p
            coeff = coeff * alphaS
        for l in range(m):
            deep_val = (deep_val
                        + coeff * (F.s(comp_rows[pos][l])
                                   - F.s(proof.composition_ood_evals[l]))
                        * zm_inv) % p
            coeff = coeff * alphaS

        cur_val = deep_val
        cur_idx = idx
        layer_coset = coset
        for li, layer_size in enumerate(layer_sizes):
            half = layer_size // f
            b = cur_idx // f
            t_pos = cur_idx % f
            lpos = layer_leaf_sets[li].index(b)
            row = proof.fri_layers[li].values[lpos * f:(lpos + 1) * f]
            _check(F.s(row[t_pos]) == cur_val,
                   f"FRI layer {li} value mismatch at query {idx}")
            row_nat = [F.s(row[bitrev_int(t, logf)]) for t in range(f)]
            i_nat = bitrev_int(b, half.bit_length() - 1)
            w_l = F.root_of_unity_int(layer_size)
            cur_val = F.s(fri_fold_host(pb, row_nat, i_nat, layer_size,
                                        layer_coset, w_l, f,
                                        F.s(fri_betas[li])))
            cur_idx = b
            layer_coset = pow(layer_coset, f, pb)

        last_size = layer_sizes[-1] // f if layer_sizes else N
        y = pow(F.root_of_unity_int(last_size),
                bitrev_int(cur_idx, last_size.bit_length() - 1), pb)
        rem_val = F.s(0)
        for c in reversed(proof.fri_remainder):
            rem_val = (rem_val * y + F.s(c)) % p
        _check(rem_val == cur_val, f"FRI remainder mismatch at query {idx}")

    return True
