"""The Goldilocks prime field p = 2^64 - 2^32 + 1 in PyTorch (port of
sandstorm_tpu/fields/goldilocks.py).

An element is a ``[..., 2]`` int32 tensor holding the (lo, hi) u32 words of
its canonical value, the JAX package's ``[..., 2]`` uint32 layout.  It is
not a Montgomery form: encoding and decoding are word splits, and the
canonical words are the element's hashing bytes.

Arithmetic goes through fields/gl_cuda.py: the CUDA kernels for CUDA
tensors, their plain PyTorch twins for CPU tensors.  Host-side values are
python ints; every function that makes a tensor from host data takes the
device explicitly.
"""

import numpy as np
import torch

from .. import _tables, telemetry
from . import gl_cuda, scan, staging
from .fp252 import Fp252
from .gl_cuda import P, binop


def _const(name: str, value: int, device):
    """Cached [2] device tensor of a canonical value."""
    return _tables.device_table(f"gl:{name}", 1, device,
                                lambda: GL.encode_ints_np([value])[0])


class GL:
    """Goldilocks field on [..., 2] int32 tensors of canonical (lo, hi)
    words."""

    NLIMBS = 2
    MODULUS = P
    BASE_MODULUS = P
    TWO_ADICITY = 32
    GENERATOR = 7
    NAME = "goldilocks"
    NUM_BYTES = 8
    # the module of its scan pair's plain batch inversion and host trip
    KERNELS = gl_cuda

    # -- host scalars ---------------------------------------------------------

    @staticmethod
    def s(v):
        return int(v) % P

    @staticmethod
    def host_mul(a: int, b: int) -> int:
        return a * b % P

    @staticmethod
    def to_hash_bytes_int(v) -> bytes:
        return int(v).to_bytes(8, "little")

    @classmethod
    def root_of_unity_int(cls, order: int) -> int:
        assert order & (order - 1) == 0 and order <= (1 << cls.TWO_ADICITY)
        return pow(cls.GENERATOR, (P - 1) // order, P)

    # -- representation -------------------------------------------------------

    @staticmethod
    def zeros(shape, device):
        return torch.zeros(tuple(shape) + (2,), dtype=torch.int32,
                           device=device)

    @staticmethod
    def ones(shape, device):
        return _const("one", 1, device).expand(tuple(shape) + (2,))

    @staticmethod
    def encode_ints_np(xs):
        """Iterable of python ints -> numpy int32 [n, 2] canonical words."""
        buf = b"".join((int(x) % P).to_bytes(8, "little") for x in xs)
        words = np.frombuffer(buf, dtype="<u4").reshape(-1, 2)
        return words.view(np.int32).copy()

    @classmethod
    def encode_ints(cls, xs, device):
        return telemetry.to_device(cls.encode_ints_np(xs), device, "encode")

    @classmethod
    def encode_int(cls, x, device):
        return cls.encode_ints([x], device)[0]

    @staticmethod
    def check_canonical_u64(cols, name: str = "encode"):
        """Raise unless every value of the numpy [n, 4] uint64 columns is a
        Goldilocks element (word 0 below p, words 1-3 zero); a span
        h2d.<name>.stage."""
        with telemetry.span(f"h2d.{name}.stage"):
            for c in cols:
                c = np.asarray(c, dtype=np.uint64)
                assert not c[..., 1:].any(), \
                    "value exceeds the Goldilocks field"
                assert (c[..., 0] < np.uint64(P)).all(), \
                    "value exceeds the Goldilocks field"

    @classmethod
    def encode_canonical_u64(cls, arr, device, name: str = "encode"):
        """numpy [..., 4] uint64 canonical LE words (the trace builders'
        field-agnostic store) -> [..., 2] tensor on `device`; a Goldilocks
        value occupies word 0 only (encode_canonical_u64_many of one
        column)."""
        arr = np.asarray(arr, dtype=np.uint64)
        (out,) = cls.encode_canonical_u64_many([arr.reshape(-1, 4)], device,
                                               name)
        return out.reshape(arr.shape[:-1] + (2,))

    @classmethod
    def encode_canonical_u64_many(cls, cols, device, name: str = "encode"):
        """List of numpy [n, 4] uint64 columns -> list of [n, 2] tensors,
        checked, then the low words in one staged upload (staging.upload's
        spans)."""
        cls.check_canonical_u64(cols, name)
        return list(staging.upload(cols, 2, device, name).unbind(0))

    @staticmethod
    def decode_np(words_np):
        """[..., 2] words (numpy int32 or uint32) -> object array of python
        ints."""
        w = np.ascontiguousarray(words_np).view(np.uint32).astype(np.uint64)
        v = w[..., 0] | (w[..., 1] << np.uint64(32))
        return v.astype(object)

    @classmethod
    def decode(cls, a, name: str = "decode"):
        """Tensor -> object array of python ints (its read a span
        d2h.<name>)."""
        return cls.decode_np(telemetry.to_host(a, name).numpy())

    @classmethod
    def decode_ints(cls, a, name: str = "decode"):
        return [int(v) for v in cls.decode(a, name).ravel()]

    @staticmethod
    def from_mont(a):
        """The canonical words: the identity (not a Montgomery form)."""
        return a

    to_bytes_words = from_mont

    # -- the cairo scheme's tree inputs ---------------------------------------

    @staticmethod
    def to_stark252_canonical(a):
        """[..., 2] canonical words -> [..., 8] canonical Stark252 limbs of
        the same integer (limbs 2..7 zero): the cairo scheme's trees read a
        GL value as the Stark252 felt it equals, as the JAX package's host
        rows do."""
        return torch.cat([a, a.new_zeros(a.shape[:-1] + (6,))], dim=-1)

    @classmethod
    def to_stark252_mont_be_words(cls, a):
        """[..., 2] canonical words -> the Montgomery form of the same
        Stark252 felt, v * 2^256 mod P252, as a 32-byte big-endian stream in
        LE u32 words (crypto/hashes.to_montgomery_bytes of the value): the
        cairo scheme's row-hash input.  A widen, a multiply by R^2 (the
        fp252_mul kernel on a CUDA tensor) and a byte reversal."""
        return Fp252.to_mont_be_words(
            Fp252.to_mont(cls.to_stark252_canonical(a)))

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
        """Elementwise inverse, inv(0) = 0, on the host (pow(x, p - 2, p)),
        as Fp252.inv: the prover inverts only the total of each batch_inv
        and scalar constants this way."""
        inv = [pow(int(v), P - 2, P) for v in np.ravel(cls.decode(a))]
        return cls.encode_ints(inv, a.device).reshape(a.shape)

    @classmethod
    def batch_inv(cls, a, axis=0):
        """Montgomery batch inversion along axis 0 (fields/scan.py)."""
        assert axis == 0
        return scan.batch_inv(cls, a)
