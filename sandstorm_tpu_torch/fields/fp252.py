"""The 252-bit Starkware prime field p = 2^251 + 17*2^192 + 1 in PyTorch.

An element is a ``[..., 8]`` int32 tensor holding the bits of eight
little-endian u32 limbs of its Montgomery form (R = 2^256).  This is the
same Montgomery integer as the JAX package's ``[..., 16]`` 16-bit digits
(sandstorm_tpu/fields/fp252.py), with limb k = d[2k] | d[2k+1] << 16, and
its limbs are the element's little-endian Montgomery bytes.

Arithmetic goes through fields/fp252_cuda.py: the CUDA kernels for CUDA
tensors, their plain PyTorch twins for CPU tensors.  Host-side values are
python ints; every function that makes a tensor from host data takes the
device explicitly.
"""

import numpy as np
import torch

from .. import _tables, telemetry
from . import fp252_cuda, scan, staging
from .fp252_cuda import P, binop

R = (1 << 256) % P
R2 = (R * R) % P


def _int_words(x: int):
    return [(x >> (32 * k)) & 0xFFFFFFFF for k in range(8)]


def _words_np(ints_np_u32):
    """numpy uint32 [..., 8] -> numpy int32 view (same bits)."""
    return np.ascontiguousarray(ints_np_u32, dtype=np.uint32).view(np.int32)


def reverse_bytes32(words):
    """[..., 8] int32 words -> the same 32 bytes in reverse order, as [..., 8]
    int32 words: the limbs reversed and each word byte-swapped.  Turns an
    element's little-endian bytes into its big-endian byte stream packed in
    LE u32 words, and back."""
    return words.contiguous().view(torch.uint8).flip(-1).view(torch.int32)


def _const(name: str, value: int, device):
    """Cached [8] device tensor of a fixed word pattern."""
    return _tables.device_table(
        name, 1, device,
        lambda: _words_np(np.array(_int_words(value), dtype=np.uint32)))


class Fp252:
    """Starkware 252-bit field on [..., 8] int32 Montgomery limb tensors."""

    NLIMBS = 8
    MODULUS = P
    BASE_MODULUS = P
    TWO_ADICITY = 192
    GENERATOR = 3
    NAME = "fp252"
    NUM_BYTES = 32
    # the module of its scan pair's plain batch inversion and host trip
    KERNELS = fp252_cuda

    # -- host scalars ---------------------------------------------------------

    @staticmethod
    def s(v):
        return int(v) % P

    @staticmethod
    def host_mul(a: int, b: int) -> int:
        return a * b % P

    @classmethod
    def root_of_unity_int(cls, order: int) -> int:
        assert order & (order - 1) == 0 and order <= (1 << cls.TWO_ADICITY)
        return pow(cls.GENERATOR, (P - 1) // order, P)

    # -- representation -------------------------------------------------------

    @staticmethod
    def zeros(shape, device):
        return torch.zeros(tuple(shape) + (8,), dtype=torch.int32,
                           device=device)

    @classmethod
    def ones(cls, shape, device):
        return _const("one_mont", R, device).expand(tuple(shape) + (8,))

    @staticmethod
    def encode_ints_np(xs):
        """Iterable of python ints -> numpy int32 [n, 8] Montgomery limbs."""
        buf = b"".join(((int(x) % P) * R % P).to_bytes(32, "little")
                       for x in xs)
        return np.frombuffer(buf, dtype="<u4").reshape(-1, 8).view(np.int32)

    @classmethod
    def encode_ints(cls, xs, device):
        return telemetry.to_device(cls.encode_ints_np(xs).copy(), device,
                                   "encode")

    @classmethod
    def encode_int(cls, x: int, device):
        return cls.encode_ints([x], device)[0]

    @classmethod
    def encode_canonical_u64(cls, arr, device, name: str = "encode"):
        """numpy [..., 4] uint64 canonical LE words -> Montgomery limbs on
        `device` (encode_canonical_u64_many of one column)."""
        arr = np.asarray(arr, dtype=np.uint64)
        (out,) = cls.encode_canonical_u64_many([arr.reshape(-1, 4)], device,
                                               name)
        return out.reshape(arr.shape[:-1] + (8,))

    @classmethod
    def encode_canonical_u64_many(cls, cols, device, name: str = "encode"):
        """List of numpy [n, 4] uint64 columns -> list of [n, 8] tensors:
        the words in one staged upload (staging.upload's spans), then one
        multiply by R^2 on `device`."""
        return list(cls.to_mont(staging.upload(cols, 8, device, name))
                    .unbind(0))

    @staticmethod
    def decode_np(words_np):
        """Canonical limbs (numpy, [..., 8] int32 or uint32) -> object array
        of python ints."""
        w = np.asarray(words_np).view(np.uint32).astype(np.uint64)
        out = np.zeros(w.shape[:-1], dtype=object)
        for k in range(8):
            out += w[..., k].astype(object) << (32 * k)
        return out

    @classmethod
    def decode(cls, a, name: str = "decode"):
        """Montgomery tensor -> numpy object array of python ints (its read
        a span d2h.<name>)."""
        return cls.decode_np(
            telemetry.to_host(cls.from_mont(a), name).numpy())

    @classmethod
    def decode_ints(cls, a, name: str = "decode"):
        return [int(v) for v in cls.decode(a, name).ravel()]

    @classmethod
    def from_mont(cls, a):
        """Montgomery -> canonical limbs (a multiply by 1 = R^-1 * R)."""
        return binop("mul", a, _const("one_canonical", 1, a.device))

    @classmethod
    def to_mont(cls, canonical):
        return binop("mul", canonical, _const("r2", R2, canonical.device))

    @classmethod
    def to_bytes_words(cls, a):
        """Canonical little-endian u32 words for hashing: [..., 8].  The
        canonical limbs ARE the element's 32-byte LE encoding."""
        return cls.from_mont(a)

    @staticmethod
    def to_mont_be_words(a):
        """The Montgomery form as a 32-byte BIG-endian stream in LE u32 words,
        [..., 8]: the byte convention of the cairo scheme's row hash
        (crypto/hashes.py to_montgomery_bytes).  The limbs ARE the Montgomery
        form's LE bytes, so this is a byte reversal."""
        return reverse_bytes32(a)

    # the cairo scheme's tree inputs (GL.to_stark252_*): the field's own
    to_stark252_canonical = from_mont
    to_stark252_mont_be_words = to_mont_be_words

    # -- arithmetic -----------------------------------------------------------

    @staticmethod
    def add(a, b):
        return binop("add", a, b)

    @staticmethod
    def sub(a, b):
        return binop("sub", a, b)

    @classmethod
    def neg(cls, a):
        return binop("sub", _const("zero", 0, a.device), a)

    @staticmethod
    def mul(a, b):
        return binop("mul", a, b)

    @classmethod
    def sqr(cls, a):
        return binop("mul", a, a)

    @classmethod
    def pow_static(cls, a, e: int):
        """a^e for a python-int exponent (square and multiply)."""
        return scan.pow_static(cls, a, e)

    @classmethod
    def inv(cls, a):
        """Elementwise inverse, inv(0) = 0.  Computed on the host with
        pow(x, p - 2, p): the prover only inverts a handful of elements this
        way (the one total of each batch_inv, scalar constants), so a device
        exponentiation chain would be 252 launches for nothing."""
        vals = cls.decode(a)
        inv = [pow(int(v), P - 2, P) for v in vals.ravel()]
        return cls.encode_ints(inv, a.device).reshape(a.shape)

    @classmethod
    def batch_inv(cls, a, axis=0):
        """Montgomery batch inversion along axis 0 (fields/scan.py)."""
        assert axis == 0
        return scan.batch_inv(cls, a)
