"""The cubic extension GF(p^3) of Goldilocks in PyTorch (port of
sandstorm_tpu/fields/gl3.py).

The reference's fast-field configuration draws its challenges, OODS point
and DEEP/FRI randomness from GF(p^3), because 64-bit draws give only about
2^-64 soundness each.  An element a0 + a1 x + a2 x^2 (x^3 = 2; x^3 - 2 is
irreducible since 2^((p-1)/3) = 2^32 - 1 != 1) is a ``[..., 6]`` int32
tensor (c0 lo, c0 hi, c1 lo, c1 hi, c2 lo, c2 hi) of canonical words.  At
python-int boundaries it is the packed integer a0 + a1 p + a2 p^2 < p^3: a
bijection with GF(p^3), so a uniform draw below p^3 is a uniform element,
and a base-field value < p embeds as itself.

Host math uses the scalar `Fq3S` (operators overloaded, so the generic
python-int evaluators run unchanged): `GL3.s(v)` wraps, `int(s)` packs.
MODULUS is p^3, so the generic Fermat exponent MODULUS - 2 inverts in
GF(p^3); domain (root-of-unity, coset) arithmetic uses BASE_MODULUS = p.

add and sub run the Goldilocks kernels on the [..., 3, 2] view; mul is one
launch of gl3_mul (fields/gl_cuda.py).  The JAX package's XLA_FUSE_SAFE
flag and jit wrapping answer an XLA:CPU compile-time problem and have no
counterpart here.
"""

import numpy as np
import torch

from .. import _tables, telemetry
from . import gl_cuda, scan, staging
from .gl_cuda import NR, P, binop, gl3_mul
from .goldilocks import GL

OMEGA = pow(NR, (P - 1) // 3, P)      # = 2^32 - 1, a primitive cube root of 1
OMEGA2 = OMEGA * OMEGA % P
Q = P ** 3


def pack(c0: int, c1: int, c2: int) -> int:
    return c0 % P + (c1 % P) * P + (c2 % P) * P * P


def unpack(v: int):
    v = int(v)
    assert 0 <= v < Q, "packed GL3 value out of range"
    c0 = v % P
    v //= P
    return c0, v % P, v // P


class Fq3S:
    """Host scalar over GF(p^3); interoperates with plain ints (which
    coerce as base-field elements: any int, reduced mod p)."""

    __slots__ = ("c",)

    def __init__(self, c0, c1=0, c2=0):
        self.c = (c0 % P, c1 % P, c2 % P)

    @classmethod
    def from_packed(cls, v):
        if isinstance(v, Fq3S):
            return v
        return cls(*unpack(v))

    @classmethod
    def _co(cls, x):
        if isinstance(x, Fq3S):
            return x
        return cls(int(x))

    def __int__(self):
        return pack(*self.c)

    def __add__(self, o):
        o = self._co(o)
        return Fq3S(*[a + b for a, b in zip(self.c, o.c)])

    __radd__ = __add__

    def __sub__(self, o):
        o = self._co(o)
        return Fq3S(*[a - b for a, b in zip(self.c, o.c)])

    def __rsub__(self, o):
        return self._co(o).__sub__(self)

    def __neg__(self):
        return Fq3S(*[-a for a in self.c])

    def __mul__(self, o):
        o = self._co(o)
        a0, a1, a2 = self.c
        b0, b1, b2 = o.c
        d0 = a0 * b0
        d1 = a0 * b1 + a1 * b0
        d2 = a0 * b2 + a1 * b1 + a2 * b0
        d3 = a1 * b2 + a2 * b1
        d4 = a2 * b2
        return Fq3S(d0 + NR * d3, d1 + NR * d4, d2)

    __rmul__ = __mul__

    def __mod__(self, m):
        # coordinates stay canonical; the evaluators' `% MODULUS` is a no-op
        return self

    def __pow__(self, e, mod=None):
        # `mod` is ignored: MODULUS - 2 = p^3 - 2 IS the field's Fermat
        # exponent, so generic pow(x, p - 2, p) code stays correct
        e = int(e)
        assert e >= 0
        result = Fq3S(1)
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def frob(self):
        """x -> x^p: the coordinates scaled by the cube roots of unity."""
        a0, a1, a2 = self.c
        return Fq3S(a0, a1 * OMEGA, a2 * OMEGA2)

    def inv(self):
        t = self.frob() * self.frob().frob()      # x^(p + p^2)
        norm = (self * t).c
        assert norm[1] == 0 and norm[2] == 0, "norm not in the base field"
        return t * pow(norm[0], P - 2, P)

    def __eq__(self, o):
        return self.c == self._co(o).c

    def __hash__(self):
        return hash(self.c)

    def __repr__(self):
        return f"Fq3S{self.c}"


def _const(name: str, values, device):
    """Cached [k, 6] (or [6] for one value) device tensor of packed
    values."""
    t = _tables.device_table(f"gl3:{name}", len(values), device,
                             lambda: GL3.encode_ints_np(values))
    return t[0] if len(values) == 1 else t


class GL3:
    """GF(p^3) on [..., 6] int32 tensors (c0_lo, c0_hi, c1_lo, c1_hi,
    c2_lo, c2_hi) of canonical words."""

    NLIMBS = 6
    MODULUS = Q              # field order: draws and Fermat exponents
    BASE_MODULUS = P         # domain (root-of-unity / coset) arithmetic
    TWO_ADICITY = GL.TWO_ADICITY
    GENERATOR = GL.GENERATOR  # the LDE coset offset, a base-field generator
    NAME = "gl3"
    NUM_BYTES = 24
    EXT_DEGREE = 3
    # the module of its scan pair's plain batch inversion and host trip
    KERNELS = gl_cuda

    # -- host scalars ---------------------------------------------------------

    @staticmethod
    def s(v):
        """Wrap a packed int (or scalar) as a host field scalar.  Negative
        ints carry base-field (integer mod p) semantics and embed as
        coordinate 0."""
        if isinstance(v, Fq3S):
            return v
        v = int(v)
        if v < 0:
            return Fq3S(v)
        return Fq3S.from_packed(v)

    @staticmethod
    def host_mul(a: int, b: int) -> int:
        return int(Fq3S.from_packed(a) * Fq3S.from_packed(b))

    @staticmethod
    def to_hash_bytes_int(v) -> bytes:
        """Host mirror of the device leaf bytes of one element: three
        8-byte LE coordinates (not the packed int's own LE bytes)."""
        return b"".join(c.to_bytes(8, "little") for c in unpack(int(v)))

    @staticmethod
    def root_of_unity_int(order: int) -> int:
        """Roots of unity (the evaluation domains) are base-field values."""
        return GL.root_of_unity_int(order)

    # -- representation -------------------------------------------------------

    @staticmethod
    def _canon(x) -> int:
        """Packed canonical int of a host value; negative ints carry
        base-field (mod p) semantics, as in `s`."""
        if isinstance(x, Fq3S):
            return pack(*x.c)
        x = int(x)
        if x < 0:
            return pack(x % P, 0, 0)
        return x % Q

    @staticmethod
    def zeros(shape, device):
        return torch.zeros(tuple(shape) + (6,), dtype=torch.int32,
                           device=device)

    @staticmethod
    def ones(shape, device):
        return _const("one", [1], device).expand(tuple(shape) + (6,))

    @classmethod
    def encode_ints_np(cls, xs):
        """Iterable of packed ints or Fq3S -> numpy int32 [n, 6]."""
        buf = b"".join(
            b"".join(c.to_bytes(8, "little") for c in unpack(cls._canon(x)))
            for x in xs)
        words = np.frombuffer(buf, dtype="<u4").reshape(-1, 6)
        return words.view(np.int32).copy()

    @classmethod
    def encode_ints(cls, xs, device):
        return telemetry.to_device(cls.encode_ints_np(xs), device, "encode")

    @classmethod
    def encode_int(cls, x, device):
        return cls.encode_ints([x], device)[0]

    @classmethod
    def encode_canonical_u64(cls, arr, device, name: str = "encode"):
        """The trace builders' store ([..., 4] u64 LE words of base-field
        values) -> [..., 6] tensors with the value in coordinate 0
        (encode_canonical_u64_many of one column)."""
        arr = np.asarray(arr, dtype=np.uint64)
        (out,) = cls.encode_canonical_u64_many([arr.reshape(-1, 4)], device,
                                               name)
        return out.reshape(arr.shape[:-1] + (6,))

    @classmethod
    def encode_canonical_u64_many(cls, cols, device, name: str = "encode"):
        """List of numpy [n, 4] uint64 columns -> list of [n, 6] tensors:
        GL's checks and staged upload of the Goldilocks words, the zero
        coordinates added on the device."""
        GL.check_canonical_u64(cols, name)
        low = staging.upload(cols, 2, device, name)
        return list(torch.cat([low, low.new_zeros(low.shape[:-1] + (4,))],
                              dim=-1).unbind(0))

    @staticmethod
    def decode_np(words_np):
        """[..., 6] words (numpy int32 or uint32) -> object array of packed
        python ints."""
        w = np.ascontiguousarray(words_np).view(np.uint32).astype(object)
        c = [w[..., 2 * k] | (w[..., 2 * k + 1] << 32) for k in range(3)]
        return c[0] + c[1] * P + c[2] * (P * P)

    @classmethod
    def decode(cls, a, name: str = "decode"):
        """Tensor -> object array of python ints (its read a span
        d2h.<name>)."""
        return cls.decode_np(telemetry.to_host(a, name).numpy())

    @classmethod
    def decode_ints(cls, a, name: str = "decode"):
        return [int(v) for v in np.ravel(cls.decode(a, name))]

    @staticmethod
    def from_mont(a):
        """The canonical words: the identity (not a Montgomery form)."""
        return a

    to_bytes_words = from_mont

    # -- arithmetic -----------------------------------------------------------

    @staticmethod
    def _gl_view(x):
        return x.reshape(x.shape[:-1] + (3, 2))

    @classmethod
    def add(cls, a, b):
        out = binop("add", cls._gl_view(a), cls._gl_view(b))
        return out.reshape(out.shape[:-2] + (6,))

    @classmethod
    def sub(cls, a, b):
        out = binop("sub", cls._gl_view(a), cls._gl_view(b))
        return out.reshape(out.shape[:-2] + (6,))

    @classmethod
    def neg(cls, a):
        return cls.sub(cls.zeros((), a.device), a)

    @staticmethod
    def mul(a, b):
        return gl3_mul(a, b)

    @classmethod
    def sqr(cls, a):
        return gl3_mul(a, a)

    @classmethod
    def pow_static(cls, a, e: int):
        """a^e for a python-int exponent (square and multiply)."""
        return scan.pow_static(cls, a, e)

    @classmethod
    def frob(cls, a):
        """x -> x^p: coordinates 1 and 2 scaled by OMEGA and OMEGA^2, one
        Goldilocks multiply by the [3, 2] table (1, OMEGA, OMEGA^2)."""
        scale = _tables.device_table(
            "gl3:frob", 3, a.device,
            lambda: GL.encode_ints_np([1, OMEGA, OMEGA2]))
        out = binop("mul", cls._gl_view(a), scale)
        return out.reshape(out.shape[:-2] + (6,))

    @classmethod
    def inv(cls, a):
        """Elementwise inverse, inv(0) = 0, on the host through Fq3S.inv
        (the norm x^(1 + p + p^2) in GF(p), one Fermat inversion): the
        prover inverts only the total of each batch_inv this way."""
        inv = [int(Fq3S.from_packed(int(v)).inv())
               for v in np.ravel(cls.decode(a))]
        return cls.encode_ints(inv, a.device).reshape(a.shape)

    @classmethod
    def batch_inv(cls, a, axis=0):
        """Montgomery batch inversion along axis 0 (fields/scan.py)."""
        assert axis == 0
        return scan.batch_inv(cls, a)
