"""Order-preserving index key formats (paper §4.1).

Every supported column type is encoded into a binary index key such that a
plain lexicographic *byte* comparison of encoded keys is equivalent to the
type's native ordering.  Multi-column keys are the concatenation of the
per-column encodings.  Encoding runs host-side in the data pipeline (numpy),
after which keys are packed into ``(n, W)`` big-endian ``uint32`` word arrays
— the representation every other layer (compression, sort, B-tree) operates
on.  Bit position ``p`` (paper convention: position 0 = most significant bit)
lives in word ``p // 32`` at shift ``31 - (p % 32)``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

__all__ = [
    "encode_int32",
    "encode_int64",
    "encode_float32",
    "encode_float64",
    "encode_decimal",
    "encode_fixed_string",
    "encode_varchar",
    "encode_multicolumn",
    "decode_int32",
    "decode_int64",
    "decode_float32",
    "decode_float64",
    "decode_decimal",
    "KeySet",
    "keys_to_words",
    "words_to_bytes",
]


# ---------------------------------------------------------------------------
# scalar encoders — each returns `bytes` whose lexicographic order matches the
# native order of the value (see Leis et al. [20] for int/float mappings).
# ---------------------------------------------------------------------------

def encode_int32(x: int) -> bytes:
    """Two's-complement int32 -> order-preserving bytes (flip sign bit)."""
    u = (int(x) & 0xFFFFFFFF) ^ 0x80000000
    return struct.pack(">I", u)


def decode_int32(b: bytes) -> int:
    u = struct.unpack(">I", b[:4])[0] ^ 0x80000000
    return u - 0x100000000 if u >= 0x80000000 else u


def encode_int64(x: int) -> bytes:
    u = (int(x) & 0xFFFFFFFFFFFFFFFF) ^ 0x8000000000000000
    return struct.pack(">Q", u)


def decode_int64(b: bytes) -> int:
    u = struct.unpack(">Q", b[:8])[0] ^ 0x8000000000000000
    return u - 0x10000000000000000 if u >= 0x8000000000000000 else u


def _float_bits_to_key(u: int, width_bits: int) -> int:
    sign = 1 << (width_bits - 1)
    # Negative floats: flip every bit (reverses their order and places them
    # below positives).  Non-negative: set the sign bit.
    if u & sign:
        return u ^ ((1 << width_bits) - 1)
    return u | sign


def _key_to_float_bits(k: int, width_bits: int) -> int:
    sign = 1 << (width_bits - 1)
    if k & sign:
        return k ^ sign
    return k ^ ((1 << width_bits) - 1)


def encode_float32(x: float) -> bytes:
    (u,) = struct.unpack(">I", struct.pack(">f", x))
    return struct.pack(">I", _float_bits_to_key(u, 32))


def decode_float32(b: bytes) -> float:
    (k,) = struct.unpack(">I", b[:4])
    return struct.unpack(">f", struct.pack(">I", _key_to_float_bits(k, 32)))[0]


def encode_float64(x: float) -> bytes:
    (u,) = struct.unpack(">Q", struct.pack(">d", x))
    return struct.pack(">Q", _float_bits_to_key(u, 64))


def decode_float64(b: bytes) -> float:
    (k,) = struct.unpack(">Q", b[:8])
    return struct.unpack(">d", struct.pack(">Q", _key_to_float_bits(k, 64)))[0]


def encode_decimal(unscaled: int | None, n_bytes: int) -> bytes:
    """decimal(m, n) per paper Fig. 4.

    ``unscaled`` is the integer value with the decimal point removed (the
    point's location lives in column metadata).  Layout: 1-byte header whose
    last bit (bit 0) is the sign (1 = negative) and second-to-last bit
    (bit 1) is the not-null flag (0 = null), followed by ``n_bytes`` of the
    magnitude, big-endian.  Mapping: negative -> toggle sign bit and all
    magnitude bits; otherwise toggle sign bit only.
    """
    if unscaled is None:
        # Nulls: header 0 sorts below every non-null entry.
        return bytes([0x00]) + b"\x00" * n_bytes
    neg = unscaled < 0
    mag = -unscaled if neg else unscaled
    if mag >= 1 << (8 * n_bytes):
        raise ValueError(f"decimal magnitude {mag} overflows {n_bytes} bytes")
    header = 0b00000010 | (1 if neg else 0)
    body = mag.to_bytes(n_bytes, "big")
    # toggle sign bit; if negative also toggle every magnitude bit
    header ^= 0b00000001
    if neg:
        body = bytes(b ^ 0xFF for b in body)
    return bytes([header]) + body


def decode_decimal(b: bytes, n_bytes: int) -> int | None:
    header, body = b[0], b[1 : 1 + n_bytes]
    if header == 0x00:
        return None
    sign_toggled = header ^ 0b00000001
    neg = bool(sign_toggled & 0b00000001)
    if neg:
        body = bytes(x ^ 0xFF for x in body)
    mag = int.from_bytes(body, "big")
    return -mag if neg else mag


def encode_fixed_string(s: bytes | str, length: int) -> bytes:
    b = s.encode("utf-8") if isinstance(s, str) else bytes(s)
    if len(b) > length:
        raise ValueError(f"fixed string longer than {length}")
    return b.ljust(length, b"\x00")


def encode_varchar(s: bytes | str, max_length: int) -> bytes:
    """varchar(n): the string itself plus one null terminator (paper §4.1.C).

    Null characters inside the string are rejected (the paper's assumption);
    the terminator makes shorter-prefix strings sort below their extensions
    and places the distinction bit inside the terminator byte.
    """
    b = s.encode("utf-8") if isinstance(s, str) else bytes(s)
    if b"\x00" in b:
        raise ValueError("varchar value must not contain null characters")
    if len(b) > max_length:
        raise ValueError(f"varchar longer than {max_length}")
    return b + b"\x00"


def encode_multicolumn(cols: Sequence[bytes]) -> bytes:
    """Index key over multiple columns = concatenation of column encodings."""
    return b"".join(cols)


# ---------------------------------------------------------------------------
# packing keys into uint32 word arrays
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class KeySet:
    """A packed set of index keys.

    words:   (n, W) uint32, big-endian word order (word 0 holds bit
             positions 0..31, bit 0 = MSB of word 0).
    lengths: (n,) int32 — original key length in bytes (shorter keys are
             zero-padded for comparison, per paper §4.1: padding does not
             affect order).
    rids:    (n,) uint32 record ids.
    """

    words: np.ndarray
    lengths: np.ndarray
    rids: np.ndarray

    @property
    def n(self) -> int:
        return int(self.words.shape[0])

    @property
    def n_words(self) -> int:
        return int(self.words.shape[1])

    @property
    def n_bits(self) -> int:
        return self.n_words * 32


def keys_to_words(
    keys: Iterable[bytes],
    rids: Sequence[int] | None = None,
    n_words: int | None = None,
) -> KeySet:
    """Pack variable-length byte keys into a (n, W) uint32 array.

    Keys shorter than the longest are padded with zero bytes (paper §4.1:
    "If one index key is shorter, it is padded with 0's in the binary
    comparison").
    """
    key_list = [bytes(k) for k in keys]
    n = len(key_list)
    if n == 0:
        raise ValueError("empty key set")
    max_len = max(len(k) for k in key_list)
    if n_words is None:
        n_words = max(1, (max_len + 3) // 4)
    elif n_words * 4 < max_len:
        raise ValueError(f"n_words={n_words} too small for {max_len}-byte keys")
    buf = np.zeros((n, n_words * 4), dtype=np.uint8)
    lengths = np.zeros((n,), dtype=np.int32)
    for i, k in enumerate(key_list):
        buf[i, : len(k)] = np.frombuffer(k, dtype=np.uint8)
        lengths[i] = len(k)
    words = buf.reshape(n, n_words, 4)
    # big-endian within each word: byte 0 is the most significant
    words = (
        words[..., 0].astype(np.uint32) << 24
        | words[..., 1].astype(np.uint32) << 16
        | words[..., 2].astype(np.uint32) << 8
        | words[..., 3].astype(np.uint32)
    )
    if rids is None:
        rid_arr = np.arange(n, dtype=np.uint32)
    else:
        rid_arr = np.asarray(rids, dtype=np.uint32)
    return KeySet(words=words, lengths=lengths, rids=rid_arr)


def words_to_bytes(words: np.ndarray, length: int | None = None) -> bytes:
    """Inverse of the packing for a single key row (testing/debug helper)."""
    w = np.asarray(words, dtype=np.uint32)
    out = bytearray()
    for word in w:
        out += int(word).to_bytes(4, "big")
    return bytes(out[:length]) if length is not None else bytes(out)
