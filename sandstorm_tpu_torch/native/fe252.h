// Shared 252-bit Starkware field arithmetic for the native host kernels
// (ecdsa.cpp).  p = 2^251 + 17*2^192 + 1, 4x64-bit limbs,
// Montgomery arithmetic (R = 2^256) with CIOS reduction — the same
// algorithmic role as the reference sandstorm's arkworks field backend
// (builtins/src/utils.rs), implemented independently.  A copy of
// sandstorm_tpu/native/fe252.h for the PyTorch port.
#pragma once

#include <cstdint>
#include <cstring>

typedef unsigned __int128 u128;
typedef uint64_t u64;

struct Fe {  // field element, 4x64 little-endian limbs
    u64 v[4];
};

// p = 2^251 + 17*2^192 + 1
static const Fe FE_P = {{0x0000000000000001ULL, 0x0000000000000000ULL,
                         0x0000000000000000ULL, 0x0800000000000011ULL}};
// -p^{-1} mod 2^64  (p = 1 mod 2^64, so p^{-1} = 1 and -1 = all-ones)
static const u64 FE_NPRIME = 0xffffffffffffffffULL;
// 1 in Montgomery form: R mod p
static const Fe FE_ONE_MONT = {{0xffffffffffffffe1ULL, 0xffffffffffffffffULL,
                                0xffffffffffffffffULL, 0x07fffffffffffdf0ULL}};
// R^2 mod p: to-Montgomery conversion constant
static const Fe FE_R2 = {{0xfffffd737e000401ULL, 0x00000001330fffffULL,
                          0xffffffffff6f8000ULL, 0x07ffd4ab5e008810ULL}};

inline bool fe_geq(const Fe& a, const Fe& b) {
    for (int i = 3; i >= 0; --i) {
        if (a.v[i] != b.v[i]) return a.v[i] > b.v[i];
    }
    return true;
}

inline void fe_sub_p(Fe& a) {  // a -= p  (assumes a >= p)
    u128 borrow = 0;
    for (int i = 0; i < 4; ++i) {
        u128 d = (u128)a.v[i] - FE_P.v[i] - (u64)borrow;
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
    if (carry || fe_geq(out, FE_P)) fe_sub_p(out);
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
            u128 s = (u128)out.v[i] + FE_P.v[i] + (u64)carry;
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
        u64 m = t[0] * FE_NPRIME;
        u128 s = (u128)m * FE_P.v[0] + t[0];
        carry = s >> 64;
        for (int j = 1; j < 4; ++j) {
            s = (u128)m * FE_P.v[j] + t[j] + (u64)carry;
            t[j - 1] = (u64)s;
            carry = s >> 64;
        }
        s = (u128)t4 + (u64)carry;
        t[3] = (u64)s;
        t[4] = (u64)(s >> 64);
    }
    Fe r = {{t[0], t[1], t[2], t[3]}};
    if (t[4] || fe_geq(r, FE_P)) fe_sub_p(r);
    out = r;
}

inline void fe_sqr(const Fe& a, Fe& out) { fe_mul(a, a, out); }

inline bool fe_is_zero(const Fe& a) {
    return (a.v[0] | a.v[1] | a.v[2] | a.v[3]) == 0;
}

// out = a^{-1} mod p (Montgomery domain in, Montgomery domain out),
// via Fermat: a^(p-2).  Callers amortize via Montgomery's batch trick.
inline void fe_inv(const Fe& a, Fe& out) {
    // p - 2, little-endian limbs
    static const u64 E[4] = {0xffffffffffffffffULL, 0xffffffffffffffffULL,
                             0xffffffffffffffffULL, 0x0800000000000010ULL};
    Fe result = FE_ONE_MONT;
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

inline void fe_to_mont(const Fe& a, Fe& out) { fe_mul(a, FE_R2, out); }

inline void fe_from_mont(const Fe& a, Fe& out) {
    static const Fe one = {{1, 0, 0, 0}};
    fe_mul(a, one, out);
}
