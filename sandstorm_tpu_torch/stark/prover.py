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
query assembly are host-side python ints.  The computation and the
Fiat-Shamir schedule are those of the JAX package, so a proof of the same
claim is the same bytes.
"""

import math
import os
import time

import torch

from .. import _tables
from ..air.expr import LdeContext, evaluate_lde, trace_arguments
from ..ntt import (coset_eval_from_coeffs, coset_powers, intt, powers_dev)
from ..ntt.ntt_cuda import batched_ntt_cols
from .ark import ArkProof, ArkQueries, FriLayer, MerkleView
from .fri import FriProver, bitrev_int, bitrev_perm
from .openings import open_columns
from .options import ProofOptions
from .scheme import get_scheme

# wall clock of each phase of the most recent prove(), as (label, seconds)
LAST_PHASES = []


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


def _lde_and_coeffs(F, cols: dict, blowup, coset):
    """All columns through one batched inverse and one batched forward
    transform: dict col -> [n, L] -> (coeffs dict, lde dict)."""
    keys = sorted(cols)
    n = cols[keys[0]].shape[0]
    device = cols[keys[0]].device
    n_inv = F.encode_int(pow(n, -1, F.BASE_MODULUS), device)
    raw = torch.stack(batched_ntt_cols(F, [cols[i] for i in keys], True), 1)
    coeffs = F.mul(raw, n_inv)                                # [n, C, L]
    ldes = coset_eval_from_coeffs(F, coeffs, n * blowup, coset)
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
          scheme=None) -> ArkProof:
    """Prove a trace on its device (trace.device)."""
    options = options or ProofOptions()
    scheme = get_scheme(scheme)
    device = trace.device
    log = _phase_logger(device)
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

    # composition = sum_i alpha^i C_i, folded as the constraint values
    # stream out of the evaluator (peak memory stays at the live set)
    alpha_comp_s = F.s(alpha_comp)

    def fold_composition(acc, cv, i):
        term = F.mul(cv, F.encode_int(pow(alpha_comp_s, i, p), device))
        return term if acc is None else F.add(acc, term)

    comp = evaluate_lde(constraints, ctx, domain_size=N,
                        fold=fold_composition)
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
    deep = _deep_compose(
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
    nonce = coin.grind_proof_of_work(options.proof_of_work_bits)
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
    """Every 1/(x - pts[k]) for x [N, L] and points pts [K, L], with one
    batch inversion in total: Montgomery's trick along the points axis
    (a forward sweep of exclusive prefix products, one batch_inv of the
    total, a backward sweep).  Returns a list of K [N, L] tensors."""
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


def _deep_compose(F, dom, targs, trace_lde, comp_lde, oods_trace_values,
                  oods_comp_values, z, g, n, alpha_deep):
    """DEEP polynomial evaluations over the LDE domain:

    D(x) = sum_j a^j (T_j(x) - t_j)/(x - z g^{k_j})
         + sum_l a^{T+l} (C_l(x) - c_l)/(x - z^m)
    """
    pb = F.BASE_MODULUS
    m = len(comp_lde)
    device = comp_lde[0].device
    offsets = sorted({off for (_, off) in targs})
    zs = F.s(z)
    points = [int(zs * pow(g, off % n, pb)) for off in offsets] \
        + [int(zs ** m)]
    K = len(points)

    # terms grouped by point, in transcript order for the alpha powers
    groups = [[] for _ in range(K)]
    alpha_s = F.s(alpha_deep)
    coeff = F.s(1)
    for j, (col, off) in enumerate(targs):
        groups[offsets.index(off)].append(
            (trace_lde[col], oods_trace_values[j], int(coeff)))
        coeff = coeff * alpha_s
    for l, c_lde in enumerate(comp_lde):
        groups[K - 1].append((c_lde, oods_comp_values[l], int(coeff)))
        coeff = coeff * alpha_s
    # one upload for all the per-term scalars and the points
    flat = F.encode_ints([t for grp in groups for (_, t, _) in grp]
                         + [c for grp in groups for (_, _, c) in grp]
                         + points, device)
    T = sum(len(grp) for grp in groups)
    tv, cv, pts = flat[:T], flat[T:2 * T], flat[2 * T:]

    invs = _deep_den_scans(F, dom.domain(), pts)
    acc = None
    pos = 0
    for k, grp in enumerate(groups):
        numer = None
        for (lde, _, _) in grp:
            term = F.mul(F.sub(lde, tv[pos]), cv[pos])
            numer = term if numer is None else F.add(numer, term)
            pos += 1
        term = F.mul(numer, invs[k])
        acc = term if acc is None else F.add(acc, term)
    return acc
