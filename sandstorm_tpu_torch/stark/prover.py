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
routes, chosen by device and field as the JAX package chooses by backend:
a CUDA Fp252 prove takes the kernels (evaluate_lde_folded: a generated
kernel a group of constraints; deep_compose: one fused DEEP kernel; their
batch inversions through the scan kernel), in no windows; CPU tensors and
Goldilocks / GF(p^3) take the eager walk (evaluate_lde, _deep_compose) in
windows, as the JAX package does off its chip.  The computation and the
Fiat-Shamir schedule are those of the JAX package, so a proof of the same
claim is the same bytes.
"""

import math
import os
import time

import torch

from .. import _native, _tables
from ..air.expr import (LdeContext, evaluate_lde, evaluate_lde_folded,
                        trace_arguments)
from ..fields.fp252_cuda import WIDE_TERMS
from ..fields.scan import batch_inv_many
from ..ntt import (coset_eval_from_coeffs, coset_powers, intt, powers_dev)
from .ark import ArkProof, ArkQueries, FriLayer, MerkleView
from .fri import FriProver, bitrev_int, bitrev_perm
from .openings import open_columns
from .options import ProofOptions
from .scheme import get_scheme

# wall clock of each phase of the most recent prove(), as (label, seconds)
LAST_PHASES = []
# windows of the domain the most recent prove() took, by phase
LAST_CHUNKS = {}


def _phase_logger(device):
    """Per-phase wall clock, recorded into LAST_PHASES and printed when
    SANDSTORM_TPU_TRACE_PHASES is set.  Each phase ends with a device
    synchronize so queued kernels are charged to the phase that queued
    them."""
    verbose = bool(os.environ.get("SANDSTORM_TPU_TRACE_PHASES"))
    t0 = time.perf_counter()
    last = [t0]
    LAST_PHASES.clear()

    def log(msg):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        LAST_PHASES.append((msg, now - last[0]))
        last[0] = now
        if verbose:
            print(f"[prove +{now - t0:7.3f}s] {msg}", flush=True)
    return log


def constraint_chunk_size(F, N):
    """Rows of one window of the constraint evaluation: the whole domain
    while one [N, L] array of F stays within 32 MB (the JAX package's
    rule, 2^23 words of 4 bytes), else windows of the largest power of two
    within it.  For Fp252's 8 int32 limbs (32 bytes an element) that is
    2^20 rows (GF(p^3), 24 bytes: 2^20 rows, 2 windows at plain-gl3's
    N = 2^21).  The eager route's rule (CPU, Goldilocks, GF(p^3)): a CUDA
    Fp252 prove evaluates in one window."""
    B = 1 << (((1 << 23) // F.NLIMBS).bit_length() - 1)
    return None if N <= B else B


# device memory the windowed DEEP's denominators may take (_deep_compose,
# the route of CPU tensors, Goldilocks and GF(p^3); a CUDA Fp252 prove
# keeps no stacks): three [K, B] stacks (the differences x - z_k, their
# exclusive prefix products, the inverses) within 12 GB of the H100's 80 GB,
# beside the LDEs and trees; K = 192 points of 32-byte elements take
# B = 2^19 rows (9.0 GiB)
DEEP_BUDGET_BYTES = 12 << 30


def deep_chunk_size(F, N, K):
    """Rows of one window of the DEEP composition: the largest power of two
    up to N whose three [K, B, L] stacks fit DEEP_BUDGET_BYTES."""
    B = N
    while B > 1 and 3 * K * B * F.NLIMBS * 4 > DEEP_BUDGET_BYTES:
        B //= 2
    return B


def _lde_and_coeffs(F, cols: dict, blowup, coset):
    """All columns through one batched inverse and one batched forward
    transform (each the four-step exchange under a mesh): dict col ->
    [n, L] -> (coeffs dict, lde dict)."""
    keys = sorted(cols)
    coeffs = intt(F, torch.stack([cols[i] for i in keys], 1))  # [n, C, L]
    ldes = coset_eval_from_coeffs(F, coeffs, coeffs.shape[0] * blowup, coset)
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
    trace's device: the same proof bytes."""
    if mesh is not None:
        from ..parallel import runtime
        with runtime.mesh_scope(mesh):
            return prove(F, air_config, trace, options, scheme)
    options = options or ProofOptions()
    scheme = get_scheme(scheme)
    device = trace.device
    # the kernels' route of phases 4 and 6 (see the module docstring)
    fused = device.type == "cuda" and F.NAME == "fp252"
    log = _phase_logger(device)
    LAST_CHUNKS.clear()
    scheme.prewarm(F, device)
    log("scheme tables")
    p = F.MODULUS          # field order (draw bound, Fermat exponents)
    pb = F.BASE_MODULUS    # domain (root-of-unity / coset) arithmetic
    n = trace.trace_len
    blowup = options.lde_blowup_factor
    N = n * blowup
    coset = F.GENERATOR
    g = F.root_of_unity_int(n)
    pub = trace.public_input

    dom = _DomainCache(F, N, coset, device)
    coin = scheme.make_coin(pub, options, n)

    # trees commit rows in bit-reversed position order: leaf q holds the
    # row at natural LDE index bitrev(q)
    brev = _tables.device_table("bitrev", N, device,
                                lambda: torch.from_numpy(bitrev_perm(N)))

    def commit_bitrev(lde_cols):
        return scheme.commit(F, [c[brev] for c in lde_cols])

    # -- 1/2: base trace commit -------------------------------------------
    base_cols = trace.base_columns()
    base_coeffs, base_lde = _lde_and_coeffs(F, base_cols, blowup, coset)
    log("base columns interpolated + extended")
    base_tree = commit_bitrev([base_lde[i] for i in sorted(base_lde)])
    coin.reseed_with_digest(base_tree.root)
    log("base commit")

    # -- 3: challenges + extension columns --------------------------------
    challenges = coin.draw_felts(p, air_config.NUM_CHALLENGES)
    ext_cols = trace.build_extension_columns(challenges)
    log("extension columns built")
    ext_coeffs, ext_lde = _lde_and_coeffs(F, ext_cols, blowup, coset)
    log("extension columns interpolated + extended")
    ext_tree = commit_bitrev([ext_lde[i] for i in sorted(ext_lde)])
    coin.reseed_with_digest(ext_tree.root)
    del base_cols, ext_cols
    trace._device_cols = None
    log("extension commit")

    # -- 4: constraint evaluation + composition ----------------------------
    hints = [int(F.s(h)) for h in
             air_config.gen_hints(n, pub, [F.s(c) for c in challenges], p)]
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
        comp = evaluate_lde_folded(constraints, ctx, N, alpha_pows)
        LAST_CHUNKS["constraint evaluation"] = 1
    else:
        # folded as the constraint values stream out of the eager walk
        # (peak memory stays at the live set)
        alpha_pows = F.encode_ints(alpha_pows, device)

        def fold_composition(acc, cv, i):
            term = F.mul(cv, alpha_pows[i])
            return term if acc is None else F.add(acc, term)

        chunk = constraint_chunk_size(F, N)
        comp = evaluate_lde(constraints, ctx, domain_size=N,
                            fold=fold_composition, chunk_size=chunk)
        LAST_CHUNKS["constraint evaluation"] = N // (chunk or N)
    log("constraint evaluation")

    # split C(x) = sum_j x^j C_j(x^m) and commit the m columns on the LDE
    # domain; each C_j has degree < n
    m = air_config.CE_BLOWUP_FACTOR
    assert blowup >= m, (
        f"lde blowup {blowup} below the layout's CE blowup {m}: "
        f"the composition polynomial would not fit the LDE domain")
    comp_coeffs_all = F.mul(intt(F, comp),
                            coset_powers(F, pow(coset, -1, pb), N, device))
    del comp
    comp_col_coeffs = [comp_coeffs_all[j::m][:n] for j in range(m)]
    del comp_coeffs_all
    comp_lde = list(coset_eval_from_coeffs(
        F, torch.stack(comp_col_coeffs, 1), N, coset).unbind(1))
    log("composition interpolated + split + extended")
    comp_tree = commit_bitrev(comp_lde)
    coin.reseed_with_digest(comp_tree.root)
    log("composition commit")

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
        extra_cols=[[comp_base + l for l in range(m)]])
    oods_trace_values = [oods_values[a] for a in targs]
    oods_comp_values = [extra[0][comp_base + l] for l in range(m)]
    coin.reseed_with_field_element_vector(
        p, oods_trace_values + oods_comp_values)
    del stack, base_coeffs, ext_coeffs, comp_col_coeffs
    log("OODS openings")

    # -- DEEP composition --------------------------------------------------
    alpha_deep = coin.draw_felt(p)
    deep = (deep_compose if fused else _deep_compose)(
        F, dom, targs, {**base_lde, **ext_lde}, comp_lde,
        oods_trace_values, oods_comp_values, z, g, n, alpha_deep)
    dom.clear()
    log("DEEP composition")

    # -- 6: FRI ------------------------------------------------------------
    fri = FriProver(F, options, N, coset, scheme)
    fri_roots = []
    evals = deep
    layer_sizes = fri.num_layers()
    f = options.fri_folding_factor
    layer_coset = coset
    for layer_size in layer_sizes:
        root = fri.commit_layer(evals, layer_size, layer_coset)
        fri_roots.append(root)
        coin.reseed_with_digest(root)
        beta = coin.draw_felt(p)
        evals = fri.fold(evals, layer_size, layer_coset, beta)
        layer_coset = pow(layer_coset, f, pb)
    log("FRI layers")
    remainder = fri.finalize_remainder(
        evals, layer_sizes[-1] // f if layer_sizes else N, layer_coset)
    coin.reseed_with_field_element_vector(p, remainder)
    log("FRI remainder")

    # -- 7: PoW + queries --------------------------------------------------
    nonce = coin.grind_proof_of_work(options.proof_of_work_bits, device)
    coin.reseed_with_int(nonce)
    indices = coin.draw_queries(options.num_queries, N)
    log("PoW + queries")

    # every row gather, tree sibling gather and FRI opening is queued on
    # ONE FetchPlan and copied to the host at once.  Drawn indices are
    # stored (bit-reversed) positions; the LDE arrays are natural order.
    from ..merkle import FetchPlan
    kN = N.bit_length() - 1
    idx_dev = torch.tensor([bitrev_int(q, kN) for q in indices],
                           dtype=torch.int64, device=device)
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

    base_views = views(tree_fins[0], base_rows)
    ext_views = views(tree_fins[1], ext_rows)
    comp_views = views(tree_fins[2], comp_rows)
    fri_ark = fri_finish(res)
    log("query assembly")

    def flat(rows):
        return [v for row in rows for v in row]

    return ArkProof(
        options=(options.num_queries, options.lde_blowup_factor,
                 options.proof_of_work_bits, options.fri_folding_factor,
                 options.fri_max_remainder_coeffs),
        trace_len=n,
        base_commitment=base_tree.root,
        ext_commitment=ext_tree.root,
        comp_commitment=comp_tree.root,
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
    concatenated.  The route of CPU tensors and of Goldilocks / GF(p^3),
    and the reference deep_compose's kernel is held to (its plain version,
    the same form as the kernel, is _deep_shifted).
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
    (python ints); a point of more than WIDE_TERMS terms is split into
    several with its shift."""
    pb = F.BASE_MODULUS
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
            terms = [(lde, c * scale % pb)
                     for (lde, _, c) in grp[s0:s0 + WIDE_TERMS]]
            C = sum(a * int(t) for (_, a), (_, t, _) in
                    zip(terms, grp[s0:s0 + WIDE_TERMS])) % pb
            points.append((shift, table, terms, C))
    zs = int(F.s(z)) % pb
    return points, (zs, pow(zs, len(comp_lde), pb))


def _deep_inverses(F, dom, zs):
    """u = 1 / (x - z) and v = 1 / (x - z^m) over the LDE domain, in one
    batch_inv_many."""
    x = dom.domain()
    return batch_inv_many(F, [F.sub(x, F.encode_int(w, x.device))
                              for w in zs])


def _deep_shifted(F, dom, targs, trace_lde, comp_lde, oods_trace_values,
                  oods_comp_values, z, g, n, alpha_deep):
    """deep_compose's kernel in plain ops over the whole domain: the
    shifted-denominator form (_deep_shifted_terms) with u and v gathered by
    torch indexing, each point's sum reduced, less its C, times its
    inverses.  The same field elements as _deep_compose."""
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
                 oods_comp_values, z, g, n, alpha_deep):
    """The DEEP evaluations of _deep_compose, for Fp252.  CPU tensors take
    _deep_compose.  A CUDA tensor takes the shifted-denominator form
    (_deep_shifted_terms; _deep_shifted is its plain version): two
    batch_invs (u, v; the scan kernel) and one launch of csrc/deep.cu over
    the whole domain, which reads each column's row once and each point's
    inverses at a shifted row: the same field elements, in no windows,
    with no [K, B] stacks and no fraction."""
    device = comp_lde[0].device
    if device.type == "cpu":
        return _deep_compose(F, dom, targs, trace_lde, comp_lde,
                             oods_trace_values, oods_comp_values, z, g, n,
                             alpha_deep)
    if F.NAME != "fp252":
        raise ValueError(f"deep_compose: the kernel is Fp252's, not "
                         f"{F.NAME}'s")
    out = deep_launch(deep_prepare(F, dom, targs, trace_lde, comp_lde,
                                   oods_trace_values, oods_comp_values, z,
                                   g, n, alpha_deep))
    LAST_CHUNKS["DEEP composition"] = 1
    return out


def deep_prepare(F, dom, targs, trace_lde, comp_lde, oods_trace_values,
                 oods_comp_values, z, g, n, alpha_deep):
    """What deep_compose's launch reads, for CUDA Fp252 columns: the
    shifted-denominator points (_deep_shifted_terms), u and v (two
    batch_invs), the launch's tables -- the column pointers, strides, term
    table, first terms, shifts and inverse tables in one int64 upload, the
    scalars a_j and C_k in one encode -- and its counts, as a dict."""
    device = comp_lde[0].device
    N = comp_lde[0].shape[0]
    points, zs = _deep_shifted_terms(F, dom, targs, trace_lde, comp_lde,
                                     oods_trace_values, oods_comp_values, z,
                                     g, n, alpha_deep)
    cols, col_of, term_col, first = [], {}, [], [0]
    for _, _, terms, _ in points:
        for lde, _ in terms:
            if id(lde) not in col_of:
                col_of[id(lde)] = len(cols)
                cols.append(lde)
            term_col.append(col_of[id(lde)])
        first.append(len(term_col))
    check_deep_shapes(cols, N, device)
    u, v = _deep_inverses(F, dom, zs)
    meta = torch.tensor([c.data_ptr() for c in cols]
                        + [c.stride(0) for c in cols] + term_col + first
                        + [sh for sh, _, _, _ in points]
                        + [tb for _, tb, _, _ in points],
                        dtype=torch.int64).to(device)
    vals = F.encode_ints([a for _, _, terms, _ in points for _, a in terms]
                         + [C for _, _, _, C in points], device)
    return {"meta": meta, "vals": vals, "u": u, "v": v, "cols": cols,
            "terms": len(term_col), "points": len(points), "N": N}


def deep_launch(prep):
    """One launch of csrc/deep.cu on deep_prepare's tables: [N, 8].  The
    tables outlive the launch on this stream (the caching allocator reuses
    their memory only for work queued after it)."""
    out = torch.empty((prep["N"], 8), dtype=torch.int32,
                      device=prep["u"].device)
    _native.launch("deep_compose", out.device, prep["meta"].data_ptr(),
                   prep["vals"].data_ptr(), prep["u"].data_ptr(),
                   prep["v"].data_ptr(), len(prep["cols"]), prep["terms"],
                   prep["points"], prep["N"], out.data_ptr())
    return out


def check_deep_shapes(cols, N, device):
    """Raise unless deep_compose's kernel takes these columns over a domain
    of N rows: N a power of two whose row words fit 32 bits (u + i * 8),
    each column [N, 8] int32 rows of 16-byte-aligned words on `device`
    whose last word's offset fits 32 bits."""
    if N & (N - 1) or N * 8 > 1 << 32:
        raise ValueError(f"deep_compose: {N} rows is not a power of two "
                         f"of at most 2^29 (32-bit row offsets)")
    for c in cols:
        if c.shape != (N, 8) or c.stride(1) != 1 or c.stride(0) % 4 \
                or c.data_ptr() % 16 or c.device != device \
                or c.dtype != torch.int32:
            raise ValueError("deep_compose: a column is not [N, 8] int32 "
                             "rows of 16-byte-aligned words on the device")
        if (N - 1) * c.stride(0) + 8 > 1 << 32:
            raise ValueError(f"deep_compose: a column's row stride "
                             f"{c.stride(0)} over {N} rows overflows 32-bit "
                             f"word offsets")
