"""The STARK prover pipeline on one device (port of
sandstorm_tpu/stark/prover.py).

  1. trace build (layout-specific, done by the caller)
  2. interpolate + coset-LDE the base columns, Merkle-commit the rows
  3. draw challenges; build the extension columns, LDE + commit
  4. evaluate the constraint DAG over the LDE domain, folding it into the
     composition polynomial with powers of one coefficient; split, commit
  5. OODS point z: open the trace polynomials at z*g^k and the composition
     columns at z^m; DEEP-compose with powers of one draw
  6. FRI commit/fold layers and remainder
  7. proof-of-work grind, query draw, Merkle/FRI decommitments

Every heavy array is a tensor on the trace's device; the transcript and the
query assembly are host-side python ints.  Phases 4 and 6 take one of two
routes, chosen by device as the JAX package chooses by backend: a CUDA
prove, in every field (Fp252, Goldilocks, GF(p^3)), takes the kernels
(evaluate_lde_folded: a generated kernel a group of constraints;
deep_compose: one fused DEEP kernel; their batch inversions through the
field's scan kernels), in no windows; CPU tensors take the eager walk
(evaluate_lde, _deep_compose) in windows, as the JAX package does off its
chip.  The computation and the Fiat-Shamir schedule are those of the JAX
package, so a proof of the same claim is the same bytes.
"""

import math

import numpy as np
import torch

from .. import _native, _tables, telemetry
from ..air.expr import (LdeContext, evaluate_lde, evaluate_lde_folded,
                        trace_arguments)
from ..fields.fp252_cuda import WIDE_TERMS
from ..fields.gl_cuda import base_embedded_verdict, check_base_embedded
from ..fields.scan import batch_inv_many
from ..ntt import coset_eval_from_coeffs, intt, powers_dev, scale_pad
from .ark import ArkProof, ArkQueries, FriLayer, MerkleView
from .fri import FriProver, bitrev_int, bitrev_perm
from .openings import open_columns
from .options import ProofOptions
from .scheme import get_scheme

# wall clock of each phase of the most recent prove(), as (label, seconds):
# the phase spans of its request (telemetry), each ending in a device
# synchronize (a span sync.phase) so queued kernels are charged to the
# phase that queued them
LAST_PHASES = []
# windows of the domain the most recent prove() took, by phase
LAST_CHUNKS = {}


def constraint_chunk_size(F, N):
    """Rows of one window of the constraint evaluation: the whole domain
    while one [N, L] array of F stays within 32 MB (the JAX package's
    rule, 2^23 words of 4 bytes), else windows of the largest power of two
    within it.  For Fp252's 8 int32 limbs (32 bytes an element) that is
    2^20 rows (GF(p^3), 24 bytes: 2^20 rows, 2 windows at N = 2^21).  The
    eager route's rule (CPU tensors): a CUDA prove evaluates in one
    window."""
    B = 1 << (((1 << 23) // F.NLIMBS).bit_length() - 1)
    return None if N <= B else B


# memory the windowed DEEP's denominators may take (_deep_compose, the
# route of CPU tensors; a CUDA prove keeps no stacks): three [K, B] stacks
# (the differences x - z_k, their exclusive prefix products, the inverses)
# within 12 GB, beside the LDEs and trees; K = 192 points of 32-byte
# elements take B = 2^19 rows (9.0 GiB)
DEEP_BUDGET_BYTES = 12 << 30


def deep_chunk_size(F, N, K):
    """Rows of one window of the DEEP composition: the largest power of two
    up to N whose three [K, B, L] stacks fit DEEP_BUDGET_BYTES."""
    B = N
    while B > 1 and 3 * K * B * F.NLIMBS * 4 > DEEP_BUDGET_BYTES:
        B //= 2
    return B


def kernel_route(device) -> bool:
    """Whether a prove on `device` takes the kernels' route of phases 4 and
    6 (see the module docstring): a CUDA device, in every field."""
    return device.type == "cuda"


def _lde_and_coeffs(F, cols: dict, blowup, coset):
    """All columns through one batched inverse and one batched forward
    transform (each the four-step exchange under a mesh): dict col ->
    [n, L] -> (coeffs dict, lde dict)."""
    keys = sorted(cols)
    with telemetry.span("lde.interpolate", cols=len(keys)):
        coeffs = intt(F, torch.stack([cols[i] for i in keys], 1))  # [n, C, L]
    with telemetry.span("lde.extend", cols=len(keys)):
        ldes = coset_eval_from_coeffs(F, coeffs, coeffs.shape[0] * blowup,
                                      coset)
    return (dict(zip(keys, coeffs.unbind(1))), dict(zip(keys, ldes.unbind(1))))


class _DomainCache:
    """Powers of the LDE coset domain, x^e on its period N / gcd(N, e),
    built once per prove and kept on the instance: clear() drops them once
    DEEP has read the domain."""

    def __init__(self, F, N, coset, device):
        self.F = F
        self.N = N
        self.coset = coset
        self.device = device
        self.w = F.root_of_unity_int(N)
        self._cache = {}

    def domain(self):
        return self.x_pow(1, self.N)

    def x_pow(self, e, period=None):
        """[period, L] tensor of (coset * w^i)^e."""
        F = self.F
        p = F.BASE_MODULUS
        if period is None:
            period = self.N // math.gcd(self.N, e)
        key = (e, period)
        if key not in self._cache:
            self._cache[key] = powers_dev(F, pow(self.w, e, p), period,
                                          self.device,
                                          start=pow(self.coset, e, p))
        return self._cache[key]

    def clear(self):
        self._cache.clear()


def prove(F, air_config, trace, options: ProofOptions = None,
          scheme=None, mesh=None) -> ArkProof:
    """Prove a trace on its device (trace.device).  With `mesh` (a
    parallel.runtime.Mesh) every transform the mesh divides runs as the
    four-step exchange NTT over its shards, and every other phase on the
    trace's device: the same proof bytes.  The prove is a span "prove" of
    the trace's request (a new one for a trace that has none), its phases
    the spans under it in LAST_PHASES's order."""
    if mesh is not None:
        from ..parallel import runtime
        with runtime.mesh_scope(mesh):
            return prove(F, air_config, trace, options, scheme)
    device = trace.device
    request = getattr(trace, "request", None)
    if request is None:
        request = telemetry.new_request()
    LAST_PHASES.clear()
    LAST_CHUNKS.clear()
    phases = telemetry.Sections(
        on_close=lambda: telemetry.synchronize(device))
    with telemetry.span("prove", request=request), phases:
        proof = _prove(F, air_config, trace, options or ProofOptions(),
                       get_scheme(scheme), phases)
    LAST_PHASES.extend((s.name, s.seconds) for s in phases.spans)
    proof.request = request
    return proof


def _prove(F, air_config, trace, options, scheme, phase):
    """prove's body: phase(label) ends the phase before (with its
    synchronize) and opens the next."""
    device = trace.device
    fused = kernel_route(device)
    phase("scheme tables")
    scheme.prewarm(F, device)
    phase("base columns interpolated + extended")
    p = F.MODULUS          # field order (draw bound, Fermat exponents)
    pb = F.BASE_MODULUS    # domain (root-of-unity / coset) arithmetic
    n = trace.trace_len
    blowup = options.lde_blowup_factor
    N = n * blowup
    coset = F.GENERATOR
    g = F.root_of_unity_int(n)
    pub = trace.public_input

    dom = _DomainCache(F, N, coset, device)
    with telemetry.span("coin.seed"):
        coin = scheme.make_coin(pub, options, n)

    # trees commit rows in bit-reversed position order: leaf q holds the
    # row at natural LDE index bitrev(q)
    brev = _tables.device_table("bitrev", N, device,
                                lambda: torch.from_numpy(bitrev_perm(N)))

    def commit_bitrev(lde_cols):
        with telemetry.span("gather.bitrev", cols=len(lde_cols)):
            rows = [c[brev] for c in lde_cols]
        return scheme.commit(F, rows)

    # -- 1/2: base trace commit -------------------------------------------
    base_cols = trace.base_columns()
    # over GF(p^3) the typed kernels (the constraint groups, the opener)
    # read a base column as its c0 word: checked here, once, on the n rows
    # (the interpolation and the LDE transform each coordinate alone, so
    # the coefficient and LDE columns of base values are base values)
    check_base_embedded(base_cols.values(), "the base trace")
    base_coeffs, base_lde = _lde_and_coeffs(F, base_cols, blowup, coset)
    phase("base commit")
    base_tree = commit_bitrev([base_lde[i] for i in sorted(base_lde)])
    base_root = base_tree.root
    coin.reseed_with_digest(base_root)
    phase("extension columns built")

    # -- 3: challenges + extension columns --------------------------------
    challenges = coin.draw_felts(p, air_config.NUM_CHALLENGES)
    with telemetry.span("extension.build"):
        ext_cols = trace.build_extension_columns(challenges)
    phase("extension columns interpolated + extended")
    ext_coeffs, ext_lde = _lde_and_coeffs(F, ext_cols, blowup, coset)
    phase("extension commit")
    ext_tree = commit_bitrev([ext_lde[i] for i in sorted(ext_lde)])
    ext_root = ext_tree.root
    coin.reseed_with_digest(ext_root)
    del base_cols, ext_cols
    trace._device_cols = None
    phase("constraint evaluation")

    # -- 4: constraint evaluation + composition ----------------------------
    with telemetry.span("air.setup"):
        hints = [int(F.s(h)) for h in
                 air_config.gen_hints(n, pub, [F.s(c) for c in challenges],
                                      p)]
        alpha_comp = coin.draw_felt(p)
        constraints = air_config.constraints(n, p, g, base_modulus=pb)
        periodic_cols = (air_config.periodic_columns(n)
                         if hasattr(air_config, "periodic_columns") else [])
        ctx = LdeContext(
            F,
            columns={**base_lde, **ext_lde},
            blowup=blowup,
            domain_fn=dom.domain,
            x_pow_fn=dom.x_pow,
            challenges=[F.encode_int(c, device) for c in challenges],
            hints=[F.encode_int(h, device) for h in hints],
            periodic=[pc.lde_fn(F, dom) for pc in periodic_cols],
        )

    # composition = sum_i alpha^i C_i
    alpha_comp_s = F.s(alpha_comp)
    alpha_pows = [pow(alpha_comp_s, i, p) for i in range(len(constraints))]
    if fused:
        # a generated kernel a group of constraints, over the whole domain
        with telemetry.span("air.evaluate", constraints=len(constraints)):
            comp = evaluate_lde_folded(constraints, ctx, N, alpha_pows,
                                       base_cols=tuple(base_lde))
        LAST_CHUNKS["constraint evaluation"] = 1
    else:
        # folded as the constraint values stream out of the eager walk
        # (peak memory stays at the live set)
        alpha_pows = F.encode_ints(alpha_pows, device)

        def fold_composition(acc, cv, i):
            term = F.mul(cv, alpha_pows[i])
            return term if acc is None else F.add(acc, term)

        chunk = constraint_chunk_size(F, N)
        with telemetry.span("air.evaluate", constraints=len(constraints)):
            comp = evaluate_lde(constraints, ctx, domain_size=N,
                                fold=fold_composition, chunk_size=chunk)
        LAST_CHUNKS["constraint evaluation"] = N // (chunk or N)
    phase("composition interpolated + split + extended")

    # split C(x) = sum_j x^j C_j(x^m) and commit the m columns on the LDE
    # domain; each C_j has degree < n
    m = air_config.CE_BLOWUP_FACTOR
    assert blowup >= m, (
        f"lde blowup {blowup} below the layout's CE blowup {m}: "
        f"the composition polynomial would not fit the LDE domain")
    with telemetry.span("lde.interpolate", cols=1):
        comp_coeffs_all = scale_pad(F, intt(F, comp), N,
                                    coset=pow(coset, -1, pb))
    del comp
    comp_col_coeffs = [comp_coeffs_all[j::m][:n] for j in range(m)]
    del comp_coeffs_all
    with telemetry.span("lde.extend", cols=m):
        comp_lde = list(coset_eval_from_coeffs(
            F, torch.stack(comp_col_coeffs, 1), N, coset).unbind(1))
    phase("composition commit")
    comp_tree = commit_bitrev(comp_lde)
    comp_root = comp_tree.root
    coin.reseed_with_digest(comp_root)
    phase("OODS openings")

    # -- 5: OODS openings --------------------------------------------------
    z = coin.draw_felt(p)
    targs = trace_arguments(constraints)
    z_m = int(F.s(z) ** m)
    comp_base = 1000  # key offset for composition columns in the stack
    stack = {**base_coeffs, **ext_coeffs}
    for l, cc in enumerate(comp_col_coeffs):
        stack[comp_base + l] = cc
    oods_values, extra = open_columns(
        F, stack, targs, z, g, n, extra_points=[z_m],
        extra_cols=[[comp_base + l for l in range(m)]],
        base_cols=tuple(base_coeffs))
    oods_trace_values = [oods_values[a] for a in targs]
    oods_comp_values = [extra[0][comp_base + l] for l in range(m)]
    with telemetry.span("coin.reseed",
                        elements=len(oods_trace_values + oods_comp_values)):
        coin.reseed_with_field_element_vector(
            p, oods_trace_values + oods_comp_values)
    del stack, base_coeffs, ext_coeffs, comp_col_coeffs
    phase("DEEP composition")

    # -- DEEP composition --------------------------------------------------
    alpha_deep = coin.draw_felt(p)
    deep = (deep_compose(F, dom, targs, {**base_lde, **ext_lde}, comp_lde,
                         oods_trace_values, oods_comp_values, z, g, n,
                         alpha_deep, base_cols=tuple(base_lde))
            if fused else
            _deep_compose(F, dom, targs, {**base_lde, **ext_lde}, comp_lde,
                          oods_trace_values, oods_comp_values, z, g, n,
                          alpha_deep))
    dom.clear()
    phase("FRI layers")

    # -- 6: FRI ------------------------------------------------------------
    fri = FriProver(F, options, N, coset, scheme)
    fri_roots = []
    evals = deep
    layer_sizes = fri.num_layers()
    f = options.fri_folding_factor
    layer_coset = coset
    for layer_size in layer_sizes:
        with telemetry.span("fri.layer", rows=layer_size):
            root = fri.commit_layer(evals, layer_size, layer_coset)
            fri_roots.append(root)
            coin.reseed_with_digest(root)
            beta = coin.draw_felt(p)
            with telemetry.span("fri.fold"):
                evals = fri.fold(evals, layer_size, layer_coset, beta)
        layer_coset = pow(layer_coset, f, pb)
    phase("FRI remainder")
    remainder = fri.finalize_remainder(
        evals, layer_sizes[-1] // f if layer_sizes else N, layer_coset)
    with telemetry.span("coin.reseed", elements=len(remainder)):
        coin.reseed_with_field_element_vector(p, remainder)
    phase("PoW + queries")

    # -- 7: PoW + queries --------------------------------------------------
    with telemetry.span("pow.grind", bits=options.proof_of_work_bits):
        nonce = coin.grind_proof_of_work(options.proof_of_work_bits, device)
    coin.reseed_with_int(nonce)
    indices = coin.draw_queries(options.num_queries, N)
    phase("query assembly")

    # every row gather, tree sibling gather and FRI opening is queued on
    # ONE FetchPlan and copied to the host at once.  Drawn indices are
    # stored (bit-reversed) positions; the LDE arrays are natural order.
    from ..merkle import FetchPlan
    with telemetry.span("queries.fetch", queries=len(indices)):
        kN = N.bit_length() - 1
        idx_dev = telemetry.to_device(
            np.array([bitrev_int(q, kN) for q in indices], dtype=np.int64),
            device, "query_index")
        plan = FetchPlan()

        def plan_rows(cols):
            return plan.add(F.from_mont(
                torch.stack([c[idx_dev] for c in cols])))

        h_base = plan_rows([base_lde[i] for i in sorted(base_lde)])
        h_ext = plan_rows([ext_lde[i] for i in sorted(ext_lde)])
        h_comp = plan_rows(comp_lde)
        tree_fins = [tree.plan_paths(indices, plan)
                     for tree in (base_tree, ext_tree, comp_tree)]
        fri_finish = fri.open_ark_plan(indices, plan)
        res = plan.run()

    def rows_from(h):
        vals = F.decode_np(res[h])  # [C, Q] object array
        return [[int(vals[c][q]) for c in range(vals.shape[0])]
                for q in range(len(indices))]

    with telemetry.span("queries.decode"):
        base_rows = rows_from(h_base)
        ext_rows = rows_from(h_ext)
        comp_rows = rows_from(h_comp)

    def views(fin, rows):
        """MerkleViews: sibling leaf + nodes above the leaf pair, plus the
        queried row's own digest (ministark field order, stark/ark.py)."""
        return [MerkleView(hashed=True, nodes=list(pth[1:]),
                           initial_leaf=pth[0],
                           sibling_leaf=scheme.hash_row(F, row))
                for pth, row in zip(fin(res), rows)]

    with telemetry.span("queries.views"):
        base_views = views(tree_fins[0], base_rows)
        ext_views = views(tree_fins[1], ext_rows)
        comp_views = views(tree_fins[2], comp_rows)
        fri_ark = fri_finish(res)
    phase.close()

    def flat(rows):
        return [v for row in rows for v in row]

    return ArkProof(
        options=(options.num_queries, options.lde_blowup_factor,
                 options.proof_of_work_bits, options.fri_folding_factor,
                 options.fri_max_remainder_coeffs),
        trace_len=n,
        base_commitment=base_root,
        ext_commitment=ext_root,
        comp_commitment=comp_root,
        fri_layers=[FriLayer(values=vals, proofs=vws, commitment=root)
                    for (vals, vws), root in zip(fri_ark, fri_roots)],
        fri_remainder=remainder,
        pow_nonce=nonce,
        queries=ArkQueries(
            base_values=flat(base_rows), ext_values=flat(ext_rows),
            comp_values=flat(comp_rows), base_proofs=base_views,
            ext_proofs=ext_views, comp_proofs=comp_views),
        execution_ood_evals=oods_trace_values,
        composition_ood_evals=oods_comp_values,
    )


def _deep_den_scans(F, x, pts):
    """Every 1/(x - pts[k]) for x [B, L] and points pts [K, L], with one
    batch inversion in total: Montgomery's trick along the points axis
    (a forward sweep of exclusive prefix products, one batch_inv of the
    total, a backward sweep).  Returns a list of K [B, L] tensors."""
    K = pts.shape[0]
    diffs = [F.sub(x, pts[k]) for k in range(K)]
    pref_excl = []
    acc = None
    for d in diffs:
        pref_excl.append(acc)
        acc = d if acc is None else F.mul(acc, d)
    inv = F.batch_inv(acc, 0)
    invs = [None] * K
    for k in range(K - 1, -1, -1):
        invs[k] = inv if pref_excl[k] is None else F.mul(inv, pref_excl[k])
        inv = F.mul(inv, diffs[k])
    return invs


def _deep_groups(F, targs, trace_lde, comp_lde, oods_trace_values,
                 oods_comp_values, alpha_deep):
    """The trace offsets in order and the terms grouped by point (one a
    trace offset, then the composition point): groups[k] = [(LDE column,
    t_j, c_j)], the coefficients c_j the powers of alpha_deep in transcript
    order (trace arguments, then the composition columns)."""
    offsets = sorted({off for (_, off) in targs})
    index = {off: k for k, off in enumerate(offsets)}
    groups = [[] for _ in range(len(offsets) + 1)]
    alpha_s = F.s(alpha_deep)
    coeff = F.s(1)
    for j, (col, off) in enumerate(targs):
        groups[index[off]].append(
            (trace_lde[col], oods_trace_values[j], int(coeff)))
        coeff = coeff * alpha_s
    for l, c_lde in enumerate(comp_lde):
        groups[-1].append((c_lde, oods_comp_values[l], int(coeff)))
        coeff = coeff * alpha_s
    return offsets, groups


def _deep_terms(F, targs, trace_lde, comp_lde, oods_trace_values,
                oods_comp_values, z, g, n, alpha_deep):
    """The DEEP points (python ints: z g^k for each row offset k of the
    trace arguments, in order, then z^m) and _deep_groups' terms."""
    pb = F.BASE_MODULUS
    m = len(comp_lde)
    offsets, groups = _deep_groups(F, targs, trace_lde, comp_lde,
                                   oods_trace_values, oods_comp_values,
                                   alpha_deep)
    zs = F.s(z)
    points = [int(zs * pow(g, off % n, pb)) for off in offsets] \
        + [int(zs ** m)]
    return points, groups


def _deep_compose(F, dom, targs, trace_lde, comp_lde, oods_trace_values,
                  oods_comp_values, z, g, n, alpha_deep):
    """DEEP polynomial evaluations over the LDE domain:

    D(x) = sum_j a^j (T_j(x) - t_j)/(x - z g^{k_j})
         + sum_l a^{T+l} (C_l(x) - c_l)/(x - z^m)

    taken in windows of the domain of deep_chunk_size's rows (within
    DEEP_BUDGET_BYTES): per window the K denominators' inverses from one
    scan, then the point groups in transcript order; the windows' sums are
    concatenated.  The route of CPU tensors, and the reference
    deep_compose's kernels are held to (their plain version, the same form
    as the kernels, is _deep_shifted).
    """
    device = comp_lde[0].device
    N = comp_lde[0].shape[0]
    points, groups = _deep_terms(F, targs, trace_lde, comp_lde,
                                 oods_trace_values, oods_comp_values, z, g,
                                 n, alpha_deep)
    K = len(points)
    # one upload for all the per-term scalars and the points
    flat = F.encode_ints([t for grp in groups for (_, t, _) in grp]
                         + [c for grp in groups for (_, _, c) in grp]
                         + points, device)
    T = sum(len(grp) for grp in groups)
    tv, cv, pts = flat[:T], flat[T:2 * T], flat[2 * T:]

    B = deep_chunk_size(F, N, K)
    LAST_CHUNKS["DEEP composition"] = N // B
    domain = dom.domain()
    out = None
    for s in range(0, N, B):
        invs = _deep_den_scans(F, domain[s:s + B], pts)
        acc = None
        pos = 0
        for k, grp in enumerate(groups):
            numer = None
            for (lde, _, _) in grp:
                term = F.mul(F.sub(lde[s:s + B], tv[pos]), cv[pos])
                numer = term if numer is None else F.add(numer, term)
                pos += 1
            term = F.mul(numer, invs[k])
            acc = term if acc is None else F.add(acc, term)
        del invs
        if B == N:
            return acc
        if out is None:
            out = torch.empty((N,) + tuple(acc.shape[1:]), dtype=acc.dtype,
                              device=device)
        out[s:s + B] = acc
    return out


def _deep_shifted_terms(F, dom, targs, trace_lde, comp_lde,
                        oods_trace_values, oods_comp_values, z, g, n,
                        alpha_deep):
    """The host's part of deep_compose: _deep_terms' points in the
    shifted-denominator form.  The LDE domain is x_i = coset w^i and a
    trace point is z g^o with g = w^b (b = N / n, o = off mod n), so
    1 / (x_i - z g^o) = g^-o u[(i - o b) mod N] with u = 1 / (x - z); the
    composition point reads v = 1 / (x - z^m) at row i.

    Returns (points, (z, z^m)): points is a list of (shift, table, terms,
    C) in transcript order, table 0 (u, read at row i - shift) or 1 (v),
    terms [(LDE column, a_j)] with a_j = c_j g^-o, and C = sum_j a_j t_j
    (python ints, packed over GF(p^3): every product and sum is taken in
    the field through F.s, since a packed int is not the element); a point
    of more than WIDE_TERMS terms is split into several with its shift."""
    p, pb = F.MODULUS, F.BASE_MODULUS
    N = comp_lde[0].shape[0]
    b = N // n
    if b * n != N or N != dom.N or pow(dom.w, b, pb) != int(g) % pb:
        raise ValueError("deep_compose: the trace generator is not w^(N/n) "
                         "of the LDE domain's generator w")
    offsets, groups = _deep_groups(F, targs, trace_lde, comp_lde,
                                   oods_trace_values, oods_comp_values,
                                   alpha_deep)
    # g^-o for the offsets mod n in increasing order, each from the last
    # (small exponents: one modular exponentiation a point would cost more
    # than the rest of the prep)
    g_inv = pow(int(g), -1, pb)
    scale_of, last, acc = {}, 0, 1
    for o in sorted({off % n for off in offsets}):
        acc = acc * pow(g_inv, o - last, pb) % pb
        scale_of[o], last = acc, o
    points = []
    for k, grp in enumerate(groups):
        if k < len(offsets):
            o = offsets[k] % n
            scale, shift, table = scale_of[o], o * b, 0
        else:
            scale, shift, table = 1, 0, 1
        for s0 in range(0, len(grp), WIDE_TERMS):
            part = grp[s0:s0 + WIDE_TERMS]
            coeffs = [F.s(c) * scale % p for (_, _, c) in part]
            C = F.s(0)
            for a, (_, t, _) in zip(coeffs, part):
                C = (C + a * F.s(t)) % p
            points.append((shift, table, [(lde, int(a)) for a, (lde, _, _)
                                          in zip(coeffs, part)], int(C)))
    zs = F.s(z)
    return points, (int(zs), int(pow(zs, len(comp_lde), p)))


def _deep_inverses(F, dom, zs, pts=None):
    """u = 1 / (x - z) and v = 1 / (x - z^m) over the LDE domain, in one
    batch_inv_many; pts: the two points already on the domain's device
    ([2, L]), else encoded here."""
    x = dom.domain()
    if pts is None:
        pts = [F.encode_int(w, x.device) for w in zs]
    return batch_inv_many(F, [F.sub(x, pts[0]), F.sub(x, pts[1])])


def _deep_shifted(F, dom, targs, trace_lde, comp_lde, oods_trace_values,
                  oods_comp_values, z, g, n, alpha_deep, base_cols=()):
    """deep_compose's kernel in plain ops over the whole domain: the
    shifted-denominator form (_deep_shifted_terms) with u and v gathered by
    torch indexing, each point's sum reduced, less its C, times its
    inverses.  The same field elements as _deep_compose (base_cols, the
    kernel's reading of base-field columns, changes no value)."""
    points, zs = _deep_shifted_terms(F, dom, targs, trace_lde, comp_lde,
                                     oods_trace_values, oods_comp_values, z,
                                     g, n, alpha_deep)
    device = comp_lde[0].device
    N = comp_lde[0].shape[0]
    u, v = _deep_inverses(F, dom, zs)
    T = sum(len(terms) for _, _, terms, _ in points)
    vals = F.encode_ints([a for _, _, terms, _ in points for _, a in terms]
                         + [C for _, _, _, C in points], device)
    rows = torch.arange(N, device=device)
    acc, j = None, 0
    for k, (shift, table, terms, _) in enumerate(points):
        s = None
        for lde, _ in terms:
            t = F.mul(lde, vals[j])
            s = t if s is None else F.add(s, t)
            j += 1
        den = v if table else u[(rows - shift) & (N - 1)]
        t = F.mul(F.sub(s, vals[T + k]), den)
        acc = t if acc is None else F.add(acc, t)
    return acc


def deep_compose(F, dom, targs, trace_lde, comp_lde, oods_trace_values,
                 oods_comp_values, z, g, n, alpha_deep, base_cols=()):
    """The DEEP evaluations of _deep_compose.  CPU tensors take
    _deep_compose.  A CUDA tensor takes the shifted-denominator form
    (_deep_shifted_terms; _deep_shifted is its plain version): one
    batch_inv_many of u and v (the field's batch inversion) and one launch
    of the field's DEEP kernel over the whole domain (Fp252: csrc/deep.cu;
    Goldilocks and GF(p^3): csrc/gl_deep.cu), which reads each column's
    row once and each point's inverses at a shifted row: the same field
    elements, in no windows, with no [K, B] stacks and no fraction.
    base_cols: the keys of trace_lde whose columns hold base-field values
    (a GF(p^3) prove's base trace; gl_deep_compose reads them as one
    Goldilocks word and multiplies them as such); Fp252 ignores it."""
    device = comp_lde[0].device
    if device.type == "cpu":
        return _deep_compose(F, dom, targs, trace_lde, comp_lde,
                             oods_trace_values, oods_comp_values, z, g, n,
                             alpha_deep)
    with telemetry.span("deep.prepare"):
        prep = deep_prepare(F, dom, targs, trace_lde, comp_lde,
                            oods_trace_values, oods_comp_values, z, g, n,
                            alpha_deep, base_cols=base_cols)
    with telemetry.span("deep.launch", terms=prep["terms"]):
        out = deep_launch(prep)
    LAST_CHUNKS["DEEP composition"] = 1
    return out


def deep_prepare(F, dom, targs, trace_lde, comp_lde, oods_trace_values,
                 oods_comp_values, z, g, n, alpha_deep, base_cols=()):
    """What deep_compose's launch reads, for columns of F (CUDA ones on the
    main path; CPU ones for deep_launch_plain): the shifted-denominator
    points (_deep_shifted_terms), u and v (one batch_inv_many), the
    launch's tables -- the column pointers, strides, term table, first
    terms, shifts and inverse tables in one int64 upload, the scalars in
    one upload (deep_scalar_words) -- and its counts, as a dict.  Over GL
    and GF(p^3) the terms' columns of base_cols' keys come first (nbase of
    them, in key order; the rest in the order the terms name them), as
    openings.open_columns orders them, and over GF(p^3) they must hold
    base-field values (gl_cuda.check_base_embedded raises otherwise: the
    kernel reads their c0 word alone).  Over Fp252 base_cols is ignored."""
    device = comp_lde[0].device
    N = comp_lde[0].shape[0]
    L = F.NLIMBS
    points, zs = _deep_shifted_terms(F, dom, targs, trace_lde, comp_lde,
                                     oods_trace_values, oods_comp_values, z,
                                     g, n, alpha_deep)
    used = {id(lde) for _, _, terms, _ in points for lde, _ in terms}
    named = [] if L == 8 else sorted(
        k for k in set(base_cols)
        if k in trace_lde and id(trace_lde[k]) in used)
    cols = [trace_lde[k] for k in named]
    col_of = {id(c): i for i, c in enumerate(cols)}
    nbase = len(cols)
    term_col, first = [], [0]
    for _, _, terms, _ in points:
        for lde, _ in terms:
            if id(lde) not in col_of:
                col_of[id(lde)] = len(cols)
                cols.append(lde)
            term_col.append(col_of[id(lde)])
        first.append(len(term_col))
    check_deep_shapes(cols, N, device, L)
    if L == 8:
        u, v = _deep_inverses(F, dom, zs)
    else:
        # the base columns' check is read back once u and v are queued,
        # and the points go up without a synchronize
        verdict = base_embedded_verdict(cols[:nbase], "deep_compose")
        u, v = _deep_inverses(F, dom, zs,
                              telemetry.to_device(
                                  F.encode_ints_np(list(zs)), device,
                                  "deep_tables", pinned=True))
        verdict()
    meta = np.array([c.data_ptr() for c in cols]
                    + [c.stride(0) for c in cols] + term_col + first
                    + [sh for sh, _, _, _ in points]
                    + [tb for _, tb, _, _ in points], dtype=np.int64)
    coeffs = [a for _, _, terms, _ in points for _, a in terms]
    consts = [C for _, _, _, C in points]
    if L == 8:
        meta = telemetry.to_device(meta, device, "deep_tables")
        vals = F.encode_ints(coeffs + consts, device)
    else:
        meta = telemetry.to_device(meta, device, "deep_tables", pinned=True)
        vals = telemetry.to_device(deep_scalar_words(L, coeffs, consts),
                                   device, "deep_tables", pinned=True)
    return {"meta": meta, "vals": vals, "u": u, "v": v, "cols": cols,
            "nbase": nbase, "terms": len(term_col), "points": len(points),
            "N": N, "L": L}


def deep_scalar_words(L: int, coeffs, consts):
    """gl_deep_compose's scalars as int32 words: each term's a_j in the form
    its products take -- over GF(p^3) (c0, c1, c2, 2 c1, 2 c2), the
    coordinates and the doubled upper ones that x^3 = 2 folds into the
    lower coordinates (gl3::Dbl); over Goldilocks the value -- then each
    point's C_k (its coordinates).  A u64 a coordinate."""
    from ..fields.gl3 import unpack
    pb = (1 << 64) - (1 << 32) + 1
    words = []
    for a in coeffs:
        if L == 2:
            words.append(int(a))
        else:
            c0, c1, c2 = unpack(int(a))
            words += [c0, c1, c2, 2 * c1 % pb, 2 * c2 % pb]
    for C in consts:
        words += [int(C)] if L == 2 else list(unpack(int(C)))
    return np.array(words, dtype=np.uint64).view(np.int32)


def deep_launch(prep):
    """One launch of the field's DEEP kernel on deep_prepare's tables:
    [N, L] (csrc/deep.cu's deep_compose for Fp252, csrc/gl_deep.cu's
    gl_deep_compose for Goldilocks and GF(p^3), which also takes nbase).
    The tables outlive the launch on this stream (the caching allocator
    reuses their memory only for work queued after it)."""
    L = prep["L"]
    k = _native.FIELD_KERNELS[L]
    out = torch.empty((prep["N"], L), dtype=torch.int32,
                      device=prep["u"].device)
    counts = (len(prep["cols"]),) if L == 8 else (len(prep["cols"]),
                                                  prep["nbase"])
    _native.launch(k["deep"], out.device, prep["meta"].data_ptr(),
                   prep["vals"].data_ptr(), prep["u"].data_ptr(),
                   prep["v"].data_ptr(), *counts, prep["terms"],
                   prep["points"], prep["N"], *k["args"], out.data_ptr())
    return out


def deep_launch_plain(F, prep):
    """gl_deep_compose's contract in F's ops (plain ones: the CPU's, or a
    field of plain ops on the card), from deep_prepare's tables as the
    kernel reads them: the columns in meta's pointer order, the first
    nbase read as their c0 word (a base-field value), each term's a_j from
    its prepared words (the doubled coordinates checked), each point's sum
    less C_k times u at its shift or v, summed over the points ->
    [N, L]."""
    L, N, T, K = prep["L"], prep["N"], prep["terms"], prep["points"]
    cols, nbase = prep["cols"], prep["nbase"]
    device = prep["u"].device
    nc = len(cols)
    meta = prep["meta"].cpu().tolist()
    if meta[:nc] != [c.data_ptr() for c in cols] \
            or meta[nc:2 * nc] != [c.stride(0) for c in cols]:
        raise ValueError("deep_launch_plain: the pointer table does not "
                         "name the columns")
    term_col = meta[2 * nc:2 * nc + T]
    first = meta[2 * nc + T:2 * nc + T + K + 1]
    shift = meta[2 * nc + T + K + 1:2 * nc + T + 2 * K + 1]
    tab = meta[2 * nc + T + 2 * K + 1:]
    H = L // 2
    U = 5 if L == 6 else 1
    words = prep["vals"].cpu().numpy().view(np.uint64).tolist()
    pb = (1 << 64) - (1 << 32) + 1
    coef = []
    for j in range(T):
        w = words[j * U:(j + 1) * U]
        if L == 6 and (w[3] != 2 * w[1] % pb or w[4] != 2 * w[2] % pb):
            raise ValueError("deep_launch_plain: a_j's doubled coordinates "
                             "are not 2 c1, 2 c2")
        coef.append(torch.from_numpy(np.array(w[:H], dtype=np.uint64)
                                     .view(np.int32)).to(device))
    consts = [torch.from_numpy(np.array(words[T * U + k * H:
                                              T * U + (k + 1) * H],
                                        dtype=np.uint64).view(np.int32))
              .to(device) for k in range(K)]

    def column(c):
        x = cols[c]
        if c < nbase and L == 6:
            x = torch.cat([x[:, :2], torch.zeros_like(x[:, 2:])], dim=1)
        return x

    u, v = prep["u"], prep["v"]
    rows = torch.arange(N, device=device)
    acc = None
    for k in range(K):
        s = None
        for j in range(first[k], first[k + 1]):
            t = F.mul(column(term_col[j]), coef[j])
            s = t if s is None else F.add(s, t)
        den = v if tab[k] else u[(rows - shift[k]) & (N - 1)]
        t = F.mul(F.sub(s, consts[k]), den)
        acc = t if acc is None else F.add(acc, t)
    return acc


def check_deep_shapes(cols, N, device, L: int = 8):
    """Raise unless the DEEP kernel of a field of L-word elements takes
    these columns over a domain of N rows: N a power of two whose row words
    fit 32 bits (u + i * L), each column [N, L] int32 rows on `device`
    whose last word's offset fits 32 bits, aligned for the kernel's loads
    (Fp252: 16-byte words of rows 4 words apart; Goldilocks and GF(p^3):
    u64 coordinates, 8 bytes, rows 2 words apart)."""
    align = _native.FIELD_KERNELS[L]["align"]
    if N & (N - 1) or N * L > 1 << 32:
        raise ValueError(f"deep_compose: {N} rows is not a power of two "
                         f"of at most 2^32 / {L} (32-bit row offsets)")
    for c in cols:
        if c.shape != (N, L) or c.stride(1) != 1 \
                or c.stride(0) % (align // 4) \
                or c.data_ptr() % align or c.device != device \
                or c.dtype != torch.int32:
            raise ValueError(f"deep_compose: a column is not [N, {L}] int32 "
                             f"rows of {align}-byte-aligned words on the "
                             f"device")
        if (N - 1) * c.stride(0) + L > 1 << 32:
            raise ValueError(f"deep_compose: a column's row stride "
                             f"{c.stride(0)} over {N} rows overflows 32-bit "
                             f"word offsets")
