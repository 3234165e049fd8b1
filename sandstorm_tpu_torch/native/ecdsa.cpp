// Batched builtin witnesses over the Starkware curve on the host: a copy of
// sandstorm_tpu/native/ecdsa.cpp for the PyTorch port, behind
// builtins/{ecdsa,ec_op,pedersen}.py's witness_limbs and new_batch.  ECDSA
// follows the reference sandstorm's builtins/src/ecdsa/mod.rs:167-331: three
// 256-step EC multiply-add traces, two 256-step doubling chains, slopes,
// x-diff inverses and scalar inverses per signature instance.
//
// The per-instance chains are inherently sequential (each step's partial
// sum feeds the next), so the batch axis is the instance: all k instances
// advance in lockstep and every step's field inversions (up to 5 per
// instance) amortize through ONE Montgomery batch inversion.
//
// C ABI (ctypes):
//   ecdsa_set_params(shift_xy, gen_xy)    — canonical LE limbs
//   ecdsa_witness_batch(msg, r, w, pubx, puby, out, status, k)
//
// out layout per instance (canonical LE 4xu64 felts):
//   [0,1536)     zg mad steps:  256 x (px, py, fx, fy, slope, x_diff_inv)
//   [1536,3072)  rq mad steps
//   [3072,4608)  wb mad steps
//   [4608,5376)  pubkey doubling chain: 256 x (x, y, slope)
//   [5376,6144)  b doubling chain
//   [6144,6160)  singles: zg_x, zg_y, rq_x, rq_y, b_x, b_y, b_slope,
//                b_x_diff_inv, wb_x, wb_y, r_point_slope,
//                r_point_x_diff_inv, r_out, w_inv, r_inv, msg_inv
// status[i]: 0 ok; 1 mimic x-collision (AIR-invalid); 2 r mismatch;
//            3 degenerate point (vertical tangent).
//
// Build: native/__init__.py runs c++ -O3 -shared -fPIC at first use.

#include <cstddef>
#include <vector>

#include "fe252.h"

namespace {

struct Pt {
    Fe x, y;
};

static Pt g_shift, g_gen;
static bool g_params_ready = false;

const Fe FE_ZERO = {{0, 0, 0, 0}};

// batch inversion with pow(0, p-2) = 0 semantics (parity with the python
// witness generator's x_diff_inv of a zero difference)
void batch_inv(std::vector<Fe>& d) {
    size_t n = d.size();
    std::vector<Fe> pref(n);
    Fe acc = FE_ONE_MONT;
    for (size_t i = 0; i < n; ++i) {
        pref[i] = acc;
        if (!fe_is_zero(d[i])) fe_mul(acc, d[i], acc);
    }
    Fe inv;
    fe_inv(acc, inv);
    for (size_t i = n; i-- > 0;) {
        if (fe_is_zero(d[i])) continue;
        Fe di;
        fe_mul(inv, pref[i], di);   // 1/d[i]
        fe_mul(inv, d[i], inv);     // strip the factor
        d[i] = di;
    }
}

inline int scalar_bit(const u64* s, int i) {
    return (int)((s[i >> 6] >> (i & 63)) & 1);
}

inline bool scalar_tail_nonzero(const u64* s, int i) {
    // any bit at position >= i set?
    int limb = i >> 6, off = i & 63;
    if (s[limb] >> off) return true;
    for (int j = limb + 1; j < 4; ++j)
        if (s[j]) return true;
    return false;
}

// affine add via precomputed dinv = 1/(p1.x - p2.x):
// slope = (p1.y - p2.y) * dinv; out may alias p1
inline void ec_add_with_inv(const Pt& p1, const Pt& p2, const Fe& dinv,
                            Fe& slope, Pt& out) {
    Fe num;
    fe_sub(p1.y, p2.y, num);
    fe_mul(num, dinv, slope);
    Fe x3, t;
    fe_sqr(slope, x3);
    fe_sub(x3, p1.x, x3);
    fe_sub(x3, p2.x, x3);
    fe_sub(p1.x, x3, t);
    fe_mul(slope, t, t);
    fe_sub(t, p1.y, out.y);
    out.x = x3;
}

// tangent slope numerator: 3x^2 + alpha (alpha = 1)
inline void tangent_num(const Pt& p, Fe& out) {
    Fe x2;
    fe_sqr(p.x, x2);
    fe_add(x2, x2, out);
    fe_add(out, x2, out);
    fe_add(out, FE_ONE_MONT, out);
}

// double via precomputed dinv = 1/(2y)
inline void ec_double_with_inv(const Pt& p, const Fe& dinv,
                               Fe& slope, Pt& out) {
    Fe num;
    tangent_num(p, num);
    fe_mul(num, dinv, slope);
    Fe x3, t;
    fe_sqr(slope, x3);
    fe_sub(x3, p.x, x3);
    fe_sub(x3, p.x, x3);
    fe_sub(p.x, x3, t);
    fe_mul(slope, t, t);
    fe_sub(t, p.y, out.y);
    out.x = x3;
}

struct MadChain {
    Pt partial, point;
    const u64* scalar;          // canonical limbs (bit source)
    int max_doublings;
    u64* out;                   // 256 x 6 felts
    bool failed;                // mimic x-collision while bits remain
};

struct DblChain {
    Pt point;
    u64* out;                   // 256 x 3 felts
};

inline void store_fe(u64* dst, const Fe& mont) {
    Fe c;
    fe_from_mont(mont, c);
    dst[0] = c.v[0]; dst[1] = c.v[1]; dst[2] = c.v[2]; dst[3] = c.v[3];
}

// one doubling-chain step: record (x, y, slope), advance via precomputed
// 1/(2y); flags a vertical tangent and freezes the chain
inline void dbl_step_apply(DblChain& c, int step, const Fe& dbl_inv,
                           int* status, size_t inst) {
    u64* dst = c.out + (size_t)step * 3 * 4;
    store_fe(dst + 0, c.point.x);
    store_fe(dst + 4, c.point.y);
    if (fe_is_zero(c.point.y)) {
        status[inst] = 3;
        static const Fe Z = {{0, 0, 0, 0}};
        store_fe(dst + 8, Z);
        return;
    }
    Fe slope;
    Pt nxt;
    ec_double_with_inv(c.point, dbl_inv, slope, nxt);
    store_fe(dst + 8, slope);
    c.point = nxt;
}

}  // namespace

extern "C" {

void ecdsa_set_params(const u64* shift_xy, const u64* gen_xy) {
    Fe t;
    for (int i = 0; i < 4; ++i) t.v[i] = shift_xy[i];
    fe_to_mont(t, g_shift.x);
    for (int i = 0; i < 4; ++i) t.v[i] = shift_xy[4 + i];
    fe_to_mont(t, g_shift.y);
    for (int i = 0; i < 4; ++i) t.v[i] = gen_xy[i];
    fe_to_mont(t, g_gen.x);
    for (int i = 0; i < 4; ++i) t.v[i] = gen_xy[4 + i];
    fe_to_mont(t, g_gen.y);
    g_params_ready = true;
}

int ecdsa_witness_batch(const u64* msg, const u64* r, const u64* w,
                        const u64* pubx, const u64* puby,
                        u64* out, int* status, size_t k) {
    if (!g_params_ready) return -1;
    const size_t OUT_FELTS = 6160;
    const size_t SINGLES = 6144;

    std::vector<Pt> pub(k);
    for (size_t i = 0; i < k; ++i) {
        Fe t;
        for (int j = 0; j < 4; ++j) t.v[j] = pubx[i * 4 + j];
        fe_to_mont(t, pub[i].x);
        for (int j = 0; j < 4; ++j) t.v[j] = puby[i * 4 + j];
        fe_to_mont(t, pub[i].y);
        status[i] = 0;
    }

    Pt neg_shift = g_shift;
    fe_sub(FE_ZERO, g_shift.y, neg_shift.y);

    // ---- phase A: zg + rq mad chains and the pubkey doubling chain ----
    std::vector<MadChain> zg(k), rq(k);
    std::vector<DblChain> pub_dbl(k);
    for (size_t i = 0; i < k; ++i) {
        zg[i] = {neg_shift, g_gen, msg + i * 4, 250, out + i * OUT_FELTS * 4,
                 false};
        rq[i] = {g_shift, pub[i], r + i * 4, 255,
                 out + (i * OUT_FELTS + 1536) * 4, false};
        pub_dbl[i] = {pub[i], out + (i * OUT_FELTS + 4608) * 4};
    }

    // per-step denominator block: [zg_xdiff, zg_dbl_2y, rq_xdiff,
    // rq_dbl_2y, pub_dbl_2y] x k
    auto run_mad_step = [&](MadChain& c, int step, Fe& xdiff_den,
                            Fe& dbl_den) {
        fe_sub(c.partial.x, c.point.x, xdiff_den);
        if (step < c.max_doublings) {
            fe_add(c.point.y, c.point.y, dbl_den);
        } else {
            dbl_den = FE_ONE_MONT;  // placeholder, not applied
        }
    };
    auto apply_mad_step = [&](MadChain& c, int step, const Fe& xdiff_den,
                              const Fe& xdiff_inv, const Fe& dbl_inv,
                              size_t inst) {
        u64* dst = c.out + (size_t)step * 6 * 4;
        store_fe(dst + 0, c.partial.x);
        store_fe(dst + 4, c.partial.y);
        store_fe(dst + 8, c.point.x);
        store_fe(dst + 12, c.point.y);
        store_fe(dst + 20, xdiff_inv);
        int bit = scalar_bit(c.scalar, step);
        if (fe_is_zero(xdiff_den) && scalar_tail_nonzero(c.scalar, step)) {
            // the AIR cannot represent a partial/addend x collision while
            // bits remain (ecdsa/mod.rs:306-331)
            c.failed = true;
            status[inst] = 1;
        }
        if (bit) {
            Fe slope;
            Pt nxt;
            ec_add_with_inv(c.partial, c.point, xdiff_inv, slope, nxt);
            store_fe(dst + 16, slope);
            c.partial = nxt;
        } else {
            static const Fe Z = {{0, 0, 0, 0}};
            store_fe(dst + 16, Z);
        }
        if (step < c.max_doublings) {
            Fe slope;
            Pt nxt;
            ec_double_with_inv(c.point, dbl_inv, slope, nxt);
            c.point = nxt;
        }
    };
    auto apply_dbl_step = [&](DblChain& c, int step, const Fe& dbl_inv,
                              size_t inst) {
        dbl_step_apply(c, step, dbl_inv, status, inst);
    };

    std::vector<Fe> dens(5 * k), xdiff_raw(2 * k);
    for (int step = 0; step < 256; ++step) {
        for (size_t i = 0; i < k; ++i) {
            run_mad_step(zg[i], step, dens[5 * i + 0], dens[5 * i + 1]);
            run_mad_step(rq[i], step, dens[5 * i + 2], dens[5 * i + 3]);
            fe_add(pub_dbl[i].point.y, pub_dbl[i].point.y, dens[5 * i + 4]);
            xdiff_raw[2 * i] = dens[5 * i + 0];
            xdiff_raw[2 * i + 1] = dens[5 * i + 2];
        }
        batch_inv(dens);
        for (size_t i = 0; i < k; ++i) {
            apply_mad_step(zg[i], step, xdiff_raw[2 * i], dens[5 * i + 0],
                           dens[5 * i + 1], i);
            apply_mad_step(rq[i], step, xdiff_raw[2 * i + 1],
                           dens[5 * i + 2], dens[5 * i + 3], i);
            apply_dbl_step(pub_dbl[i], step, dens[5 * i + 4], i);
        }
    }

    // ---- phase B: b = zg + rq ----
    std::vector<Pt> b(k);
    std::vector<Fe> b_dens(k);
    for (size_t i = 0; i < k; ++i)
        fe_sub(zg[i].partial.x, rq[i].partial.x, b_dens[i]);
    std::vector<Fe> b_dinv = b_dens;
    batch_inv(b_dinv);
    for (size_t i = 0; i < k; ++i) {
        u64* singles = out + (i * OUT_FELTS + SINGLES) * 4;
        store_fe(singles + 0 * 4, zg[i].partial.x);
        store_fe(singles + 1 * 4, zg[i].partial.y);
        store_fe(singles + 2 * 4, rq[i].partial.x);
        store_fe(singles + 3 * 4, rq[i].partial.y);
        if (fe_is_zero(b_dens[i])) {
            status[i] = status[i] ? status[i] : 1;
            b[i] = g_shift;  // placeholder; instance already failed
            continue;
        }
        Fe slope;
        ec_add_with_inv(zg[i].partial, rq[i].partial, b_dinv[i], slope, b[i]);
        store_fe(singles + 4 * 4, b[i].x);
        store_fe(singles + 5 * 4, b[i].y);
        store_fe(singles + 6 * 4, slope);
        store_fe(singles + 7 * 4, b_dinv[i]);
    }

    // ---- phase C: wb mad chain and the b doubling chain ----
    std::vector<MadChain> wb(k);
    std::vector<DblChain> b_dbl(k);
    for (size_t i = 0; i < k; ++i) {
        wb[i] = {g_shift, b[i], w + i * 4, 255,
                 out + (i * OUT_FELTS + 3072) * 4, false};
        b_dbl[i] = {b[i], out + (i * OUT_FELTS + 5376) * 4};
    }
    std::vector<Fe> dens_c(3 * k), xdiff_c(k);
    for (int step = 0; step < 256; ++step) {
        for (size_t i = 0; i < k; ++i) {
            run_mad_step(wb[i], step, dens_c[3 * i + 0], dens_c[3 * i + 1]);
            fe_add(b_dbl[i].point.y, b_dbl[i].point.y, dens_c[3 * i + 2]);
            xdiff_c[i] = dens_c[3 * i + 0];
        }
        batch_inv(dens_c);
        for (size_t i = 0; i < k; ++i) {
            apply_mad_step(wb[i], step, xdiff_c[i], dens_c[3 * i + 0],
                           dens_c[3 * i + 1], i);
            apply_dbl_step(b_dbl[i], step, dens_c[3 * i + 2], i);
        }
    }

    // ---- finals: r extraction + scalar inverses ----
    // denominators: [wb.x - neg_shift.x, w, r, msg] x k
    std::vector<Fe> fin(4 * k), fin_raw(k);
    for (size_t i = 0; i < k; ++i) {
        fe_sub(wb[i].partial.x, neg_shift.x, fin[4 * i + 0]);
        fin_raw[i] = fin[4 * i + 0];
        Fe t;
        for (int j = 0; j < 4; ++j) t.v[j] = w[i * 4 + j];
        fe_to_mont(t, fin[4 * i + 1]);
        for (int j = 0; j < 4; ++j) t.v[j] = r[i * 4 + j];
        fe_to_mont(t, fin[4 * i + 2]);
        for (int j = 0; j < 4; ++j) t.v[j] = msg[i * 4 + j];
        fe_to_mont(t, fin[4 * i + 3]);
    }
    batch_inv(fin);
    for (size_t i = 0; i < k; ++i) {
        u64* singles = out + (i * OUT_FELTS + SINGLES) * 4;
        store_fe(singles + 8 * 4, wb[i].partial.x);
        store_fe(singles + 9 * 4, wb[i].partial.y);
        if (fe_is_zero(fin_raw[i])) {
            status[i] = status[i] ? status[i] : 1;
            continue;
        }
        // r_point: wb + neg_shift; slope = calculate_slope(wb, neg_shift)
        Fe slope;
        Pt rpt;
        ec_add_with_inv(wb[i].partial, neg_shift, fin[4 * i + 0], slope, rpt);
        store_fe(singles + 10 * 4, slope);
        store_fe(singles + 11 * 4, fin[4 * i + 0]);
        store_fe(singles + 12 * 4, rpt.x);
        store_fe(singles + 13 * 4, fin[4 * i + 1]);
        store_fe(singles + 14 * 4, fin[4 * i + 2]);
        store_fe(singles + 15 * 4, fin[4 * i + 3]);
        // r check: canonical compare against the input scalar
        Fe rx;
        fe_from_mont(rpt.x, rx);
        bool match = rx.v[0] == r[i * 4] && rx.v[1] == r[i * 4 + 1]
                     && rx.v[2] == r[i * 4 + 2] && rx.v[3] == r[i * 4 + 3];
        if (!match && status[i] == 0) status[i] = 2;
    }
    return 0;
}

// Batched Pedersen builtin witness (builtins/src/pedersen/mod.rs:63-176):
// two 256-step EC subset-sums per instance over FIXED doubling chains
// (P1/P2 for element a, P3/P4 for b) — the chains are shared across all
// instances, so the per-step state is just each instance's partial sum,
// and the conditional-add slopes amortize through one batch inversion
// per step like the other builtins.
//
// out layout per instance (canonical LE 4xu64 felts):
//   [0,768)      a steps: 256 x (px, py, slope)
//   [768,1536)   b steps: 256 x (px, py, slope)
//   [1536,1538)  singles: out_x, out_y (the final partial sum)
// status: 0 ok; 1 AIR-invalid (x-collision on a set bit, or a set bit
// beyond the 252-point chain).

static Pt g_chain[2][252];
static bool g_chains_ready = false;

extern "C" void pedersen_set_chains(const u64* c0_xy, const u64* c1_xy) {
    const u64* srcs[2] = {c0_xy, c1_xy};
    for (int w = 0; w < 2; ++w) {
        for (int i = 0; i < 252; ++i) {
            Fe t;
            for (int j = 0; j < 4; ++j) t.v[j] = srcs[w][i * 8 + j];
            fe_to_mont(t, g_chain[w][i].x);
            for (int j = 0; j < 4; ++j) t.v[j] = srcs[w][i * 8 + 4 + j];
            fe_to_mont(t, g_chain[w][i].y);
        }
    }
    g_chains_ready = true;
}

namespace {

// one subset-sum phase (element `which`) for all instances in lockstep
void pedersen_element_phase(std::vector<Pt>& partial, const u64* scalars,
                            int which, u64* out, size_t out_stride,
                            int* status, size_t k) {
    std::vector<Fe> dens(k), raw(k);
    for (int step = 0; step < 256; ++step) {
        const Pt& cp = g_chain[which][step < 252 ? step : 251];
        for (size_t i = 0; i < k; ++i) {
            fe_sub(partial[i].x, cp.x, dens[i]);
            raw[i] = dens[i];
        }
        batch_inv(dens);
        for (size_t i = 0; i < k; ++i) {
            u64* dst = out + i * out_stride * 4 + (size_t)step * 3 * 4;
            store_fe(dst + 0, partial[i].x);
            store_fe(dst + 4, partial[i].y);
            int bit = scalar_bit(scalars + i * 4, step);
            if (bit && (step >= 252 || fe_is_zero(raw[i]))) {
                status[i] = 1;
                static const Fe Z = {{0, 0, 0, 0}};
                store_fe(dst + 8, Z);
                continue;
            }
            if (bit) {
                Fe slope;
                Pt nxt;
                ec_add_with_inv(partial[i], cp, dens[i], slope, nxt);
                store_fe(dst + 8, slope);
                partial[i] = nxt;
            } else {
                static const Fe Z = {{0, 0, 0, 0}};
                store_fe(dst + 8, Z);
            }
        }
    }
}

}  // namespace

extern "C" int pedersen_witness_batch(const u64* a, const u64* b,
                                      u64* out, int* status, size_t k) {
    if (!g_params_ready || !g_chains_ready) return -1;
    const size_t OUT_FELTS = 1538;
    std::vector<Pt> partial(k, g_shift);
    for (size_t i = 0; i < k; ++i) status[i] = 0;
    pedersen_element_phase(partial, a, 0, out, OUT_FELTS, status, k);
    pedersen_element_phase(partial, b, 1, out + 768 * 4, OUT_FELTS,
                           status, k);
    for (size_t i = 0; i < k; ++i) {
        u64* singles = out + (i * OUT_FELTS + 1536) * 4;
        store_fe(singles + 0, partial[i].x);
        store_fe(singles + 4, partial[i].y);
    }
    return 0;
}

// Batched EC-op builtin witness: r = p + m*q (builtins/src/ec_op/mod.rs).
// Reuses the ECDSA chain machinery; unlike ECDSA's 250-doubling generator
// chain, the addend doubles on every one of the 256 steps.
//
// out layout per instance (canonical LE 4xu64 felts):
//   [0,1536)     r mad steps: 256 x (px, py, qx, qy, slope, x_diff_inv)
//   [1536,2304)  q doubling chain: 256 x (x, y, slope)
//   [2304,2306)  singles: r_x, r_y
int ec_op_witness_batch(const u64* px, const u64* py, const u64* qx,
                        const u64* qy, const u64* m,
                        u64* out, int* status, size_t k) {
    const size_t OUT_FELTS = 2306;
    std::vector<MadChain> mad(k);
    std::vector<DblChain> qdbl(k);
    for (size_t i = 0; i < k; ++i) {
        status[i] = 0;
        Pt p, q;
        Fe t;
        for (int j = 0; j < 4; ++j) t.v[j] = px[i * 4 + j];
        fe_to_mont(t, p.x);
        for (int j = 0; j < 4; ++j) t.v[j] = py[i * 4 + j];
        fe_to_mont(t, p.y);
        for (int j = 0; j < 4; ++j) t.v[j] = qx[i * 4 + j];
        fe_to_mont(t, q.x);
        for (int j = 0; j < 4; ++j) t.v[j] = qy[i * 4 + j];
        fe_to_mont(t, q.y);
        mad[i] = {p, q, m + i * 4, 256, out + i * OUT_FELTS * 4, false};
        qdbl[i] = {q, out + (i * OUT_FELTS + 1536) * 4};
    }
    std::vector<Fe> dens(3 * k), xdiff_raw(k);
    for (int step = 0; step < 256; ++step) {
        for (size_t i = 0; i < k; ++i) {
            fe_sub(mad[i].partial.x, mad[i].point.x, dens[3 * i + 0]);
            fe_add(mad[i].point.y, mad[i].point.y, dens[3 * i + 1]);
            fe_add(qdbl[i].point.y, qdbl[i].point.y, dens[3 * i + 2]);
            xdiff_raw[i] = dens[3 * i + 0];
        }
        batch_inv(dens);
        for (size_t i = 0; i < k; ++i) {
            auto apply = [&](MadChain& c, const Fe& xdiff_den,
                             const Fe& xdiff_inv, const Fe& dbl_inv) {
                u64* dst = c.out + (size_t)step * 6 * 4;
                store_fe(dst + 0, c.partial.x);
                store_fe(dst + 4, c.partial.y);
                store_fe(dst + 8, c.point.x);
                store_fe(dst + 12, c.point.y);
                store_fe(dst + 20, xdiff_inv);
                int bit = scalar_bit(c.scalar, step);
                if (fe_is_zero(xdiff_den)
                        && scalar_tail_nonzero(c.scalar, step)) {
                    c.failed = true;
                    status[i] = 1;
                }
                if (bit) {
                    Fe slope;
                    Pt nxt;
                    ec_add_with_inv(c.partial, c.point, xdiff_inv, slope,
                                    nxt);
                    store_fe(dst + 16, slope);
                    c.partial = nxt;
                } else {
                    static const Fe Z = {{0, 0, 0, 0}};
                    store_fe(dst + 16, Z);
                }
                Fe slope;
                Pt nxt;
                ec_double_with_inv(c.point, dbl_inv, slope, nxt);
                c.point = nxt;
            };
            apply(mad[i], xdiff_raw[i], dens[3 * i + 0], dens[3 * i + 1]);
            dbl_step_apply(qdbl[i], step, dens[3 * i + 2], status, i);
        }
    }
    for (size_t i = 0; i < k; ++i) {
        u64* singles = out + (i * OUT_FELTS + 2304) * 4;
        store_fe(singles + 0, mad[i].partial.x);
        store_fe(singles + 4, mad[i].partial.y);
    }
    return 0;
}

}  // extern "C"
