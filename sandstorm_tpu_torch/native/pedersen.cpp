// Batched Pedersen hashing over the Starkware curve on the host: a copy of
// sandstorm_tpu/native/pedersen.cpp for the PyTorch port.  The port sends
// the small top levels of the friendly Merkle tree here (fewer than
// merkle.DEVICE_PEDERSEN_MIN_PAIRS pairs), and the transcript's reseed and
// the verifier's path checks hash one pair at a time; the big levels run on
// the GPU (csrc/ec_madd.cu).
//
// Field: p = 2^251 + 17*2^192 + 1, 4x64-bit limbs, Montgomery arithmetic
// (R = 2^256) with CIOS reduction.  Curve: y^2 = x^3 + x + BETA.
//
// Strategy: 8-bit fixed windows over both scalars with precomputed tables
// (supplied by the caller, who owns the exact curve constants), affine
// accumulation in lockstep across the batch, and ONE modular inversion per
// window step via Montgomery's batch-inversion trick.
//
// C ABI (ctypes):
//   pedersen_set_table(table, shift) — load window tables (Montgomery limbs)
//   pedersen_hash_pairs(a, b, out, k) — canonical LE limbs in/out
//
// Build: native/__init__.py runs c++ -O3 -shared -fPIC at first use.

#include <cstdint>
#include <cstring>
#include <vector>

typedef unsigned __int128 u128;
typedef uint64_t u64;

namespace {

struct Fe {  // field element, 4x64 little-endian limbs
    u64 v[4];
};

// p = 2^251 + 17*2^192 + 1
static const Fe P = {{0x0000000000000001ULL, 0x0000000000000000ULL,
                      0x0000000000000000ULL, 0x0800000000000011ULL}};
// -p^{-1} mod 2^64  (p = 1 mod 2^64, so p^{-1} = 1 and -1 = all-ones)
static const u64 NPRIME = 0xffffffffffffffffULL;
// 1 in Montgomery form: R mod p = 2^256 mod p
static const Fe ONE_MONT = {{0xffffffffffffffe1ULL, 0xffffffffffffffffULL,
                             0xffffffffffffffffULL, 0x07fffffffffffdf0ULL}};

inline bool geq(const Fe& a, const Fe& b) {
    for (int i = 3; i >= 0; --i) {
        if (a.v[i] != b.v[i]) return a.v[i] > b.v[i];
    }
    return true;
}

inline void sub_p(Fe& a) {  // a -= p  (assumes a >= p)
    u128 borrow = 0;
    for (int i = 0; i < 4; ++i) {
        u128 d = (u128)a.v[i] - P.v[i] - (u64)borrow;
        a.v[i] = (u64)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}

inline void fe_add(const Fe& a, const Fe& b, Fe& out) {
    u128 carry = 0;
    for (int i = 0; i < 4; ++i) {
        u128 s = (u128)a.v[i] + b.v[i] + (u64)carry;
        out.v[i] = (u64)s;
        carry = s >> 64;
    }
    // p < 2^252 so one conditional subtract suffices (no limb overflow:
    // a, b < p => sum < 2^253)
    if (carry || geq(out, P)) sub_p(out);
}

inline void fe_sub(const Fe& a, const Fe& b, Fe& out) {
    u128 borrow = 0;
    for (int i = 0; i < 4; ++i) {
        u128 d = (u128)a.v[i] - b.v[i] - (u64)borrow;
        out.v[i] = (u64)d;
        borrow = (d >> 64) ? 1 : 0;
    }
    if (borrow) {  // out += p
        u128 carry = 0;
        for (int i = 0; i < 4; ++i) {
            u128 s = (u128)out.v[i] + P.v[i] + (u64)carry;
            out.v[i] = (u64)s;
            carry = s >> 64;
        }
    }
}

// CIOS Montgomery multiplication: out = a*b*R^{-1} mod p
inline void fe_mul(const Fe& a, const Fe& b, Fe& out) {
    u64 t[5] = {0, 0, 0, 0, 0};
    for (int i = 0; i < 4; ++i) {
        // t += a[i] * b
        u128 carry = 0;
        for (int j = 0; j < 4; ++j) {
            u128 s = (u128)a.v[i] * b.v[j] + t[j] + (u64)carry;
            t[j] = (u64)s;
            carry = s >> 64;
        }
        u64 t4 = t[4] + (u64)carry;  // cannot overflow: sum < 2^129ish
        // m = t[0] * n' mod 2^64;  t = (t + m*p) / 2^64
        u64 m = t[0] * NPRIME;
        u128 s = (u128)m * P.v[0] + t[0];
        carry = s >> 64;
        for (int j = 1; j < 4; ++j) {
            s = (u128)m * P.v[j] + t[j] + (u64)carry;
            t[j - 1] = (u64)s;
            carry = s >> 64;
        }
        s = (u128)t4 + (u64)carry;
        t[3] = (u64)s;
        t[4] = (u64)(s >> 64);
    }
    Fe r = {{t[0], t[1], t[2], t[3]}};
    if (t[4] || geq(r, P)) sub_p(r);
    out = r;
}

inline void fe_sqr(const Fe& a, Fe& out) { fe_mul(a, a, out); }

// out = a^{-1} mod p (Montgomery domain in, Montgomery domain out),
// via Fermat: a^(p-2).  Only used once per batch step, cost amortized.
void fe_inv(const Fe& a, Fe& out) {
    // p - 2, little-endian limbs
    static const u64 E[4] = {0xffffffffffffffffULL, 0xffffffffffffffffULL,
                             0xffffffffffffffffULL, 0x0800000000000010ULL};
    Fe result = ONE_MONT;
    Fe base = a;
    for (int limb = 0; limb < 4; ++limb) {
        u64 e = E[limb];
        for (int bit = 0; bit < 64; ++bit) {
            if (e & 1) fe_mul(result, base, result);
            fe_sqr(base, base);
            e >>= 1;
        }
    }
    out = result;
}

struct Pt {
    Fe x, y;
};

// window tables: [2 scalars][32 windows][256 entries] (entry 0 unused),
// affine Montgomery coordinates.  Flattened by the python caller.
static std::vector<Pt> g_table;
static Pt g_shift;
static bool g_ready = false;

inline const Pt& table_at(int scalar, int window, int value) {
    return g_table[((size_t)scalar * 32 + window) * 256 + value];
}

}  // namespace

extern "C" {

// table: (2*32*256) points * 8 u64 (x limbs, y limbs), Montgomery form.
// shift: 8 u64.  Entries with value 0 are ignored.
void pedersen_set_table(const u64* table, const u64* shift) {
    g_table.resize((size_t)2 * 32 * 256);
    for (size_t i = 0; i < g_table.size(); ++i) {
        std::memcpy(g_table[i].x.v, table + i * 8, 32);
        std::memcpy(g_table[i].y.v, table + i * 8 + 4, 32);
    }
    std::memcpy(g_shift.x.v, shift, 32);
    std::memcpy(g_shift.y.v, shift + 4, 32);
    g_ready = true;
}

// a, b: k scalars each as 4 canonical LE u64 limbs; out: k felts (canonical).
// Computes out[i] = x-coordinate of (shift + sum-of-windows) per the
// Pedersen subset-sum (window tables fold the P1/P2-chain structure).
int pedersen_hash_pairs(const u64* a, const u64* b, u64* out, size_t k) {
    if (!g_ready) return -1;
    std::vector<Fe> X(k), Y(k), dx(k), pref(k), tx(k), ty(k);
    std::vector<unsigned char> active(k);
    // scalars -> montgomery not needed (window values are plain bits)
    for (size_t i = 0; i < k; ++i) {
        X[i] = g_shift.x;
        Y[i] = g_shift.y;
    }
    for (int scalar = 0; scalar < 2; ++scalar) {
        const u64* s = scalar ? b : a;
        for (int w = 0; w < 32; ++w) {
            // gather the table point per element; value = bits [8w, 8w+8)
            for (size_t i = 0; i < k; ++i) {
                const u64* limbs = s + i * 4;
                int bitpos = 8 * w;
                int limb = bitpos >> 6, off = bitpos & 63;
                u64 v = limbs[limb] >> off;
                if (off > 0 && limb < 3) v |= limbs[limb + 1] << (64 - off);
                int value = (int)(v & 0xff);
                active[i] = value != 0;
                if (active[i]) {
                    const Pt& t = table_at(scalar, w, value);
                    tx[i] = t.x;
                    ty[i] = t.y;
                    fe_sub(t.x, X[i], dx[i]);
                } else {
                    dx[i] = ONE_MONT;
                }
            }
            // batch inversion of dx[] (Montgomery's trick)
            Fe acc = ONE_MONT;
            for (size_t i = 0; i < k; ++i) {
                pref[i] = acc;
                fe_mul(acc, dx[i], acc);
            }
            Fe inv_acc;
            fe_inv(acc, inv_acc);
            for (size_t i = k; i-- > 0;) {
                Fe inv_i;
                fe_mul(inv_acc, pref[i], inv_i);   // 1/dx[i]
                fe_mul(inv_acc, dx[i], inv_acc);   // strip the factor
                if (!active[i]) continue;
                // affine add: s = (ty - Y)/(tx - X)
                Fe num, slope, x3, t;
                fe_sub(ty[i], Y[i], num);
                fe_mul(num, inv_i, slope);
                fe_sqr(slope, x3);
                fe_sub(x3, X[i], x3);
                fe_sub(x3, tx[i], x3);            // x3 = s^2 - x1 - x2
                fe_sub(X[i], x3, t);
                fe_mul(slope, t, t);
                fe_sub(t, Y[i], Y[i]);            // y3 = s(x1-x3) - y1
                X[i] = x3;
            }
        }
    }
    // montgomery -> canonical: multiply by 1 (fe_mul by literal one)
    Fe one = {{1, 0, 0, 0}};
    for (size_t i = 0; i < k; ++i) {
        Fe c;
        fe_mul(X[i], one, c);
        std::memcpy(out + i * 4, c.v, 32);
    }
    return 0;
}

}  // extern "C"
