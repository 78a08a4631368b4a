"""Wire integrity for stream frames: CRC32C-framed headers, typed errors.

A copy of the reference's ``replication/wire.py``: the same header, the
same checksum, the same typed errors, so a frame packed by either package
verifies in the other.  Only the checksum's evaluation differs for large
payloads (see :func:`crc32c`).
Raw npz archives on the wire let any bit flip, truncation, or foreign
payload surface as whatever ``zipfile``/``numpy`` happened to raise (or
worse, decode to garbage).  This module is the integrity layer underneath
the stream layer's ``encode_frame`` (ROADMAP Queue 1 item 10):

* every frame gets a fixed 28-byte header — magic, format version, frame
  kind tag, a publisher-assigned **monotonic sequence number**, payload
  length, and a **CRC32C** checksum covering header fields + payload;
* :func:`unpack_frame` verifies all of it and raises **typed** errors a
  supervisor can act on: :class:`FrameCorrupt` for damage (bad checksum,
  truncated or padded buffer — *re-read, then catch up*) and
  :class:`FrameSchemaError` for malformed-but-intact payloads (unknown
  version or kind, not-an-npz, missing fields — *never heals, skip to a
  checkpoint*);
* payloads whose first bytes are not the magic are **legacy v0 frames**
  (pre-header spools): :func:`is_framed` lets the decoder fall back to the
  raw-npz path so old spools still decode.

CRC32C (Castagnoli) is computed with a table-driven pure-Python loop for
small payloads (KBs of change-log columns) and with a chunk-parallel
numpy evaluation for large ones (a genesis batch of 10M 64-byte keys is
about 800 MB, which the byte loop takes minutes over); the checksum
choice matches what storage/wire protocols (iSCSI, ext4, gRPC) use, so
captured frames verify with standard tools.
"""

from __future__ import annotations

import functools
import struct
from dataclasses import dataclass

import numpy as np

__all__ = [
    "WireError",
    "FrameCorrupt",
    "FrameSchemaError",
    "FrameHeader",
    "MAGIC",
    "WIRE_VERSION",
    "HEADER_SIZE",
    "crc32c",
    "is_framed",
    "pack_frame",
    "unpack_frame",
]


class WireError(RuntimeError):
    """Base class for frame integrity failures."""


class FrameCorrupt(WireError):
    """The frame bytes are damaged (checksum mismatch, truncated or
    over-long buffer) — a re-read may heal it; a persistent corruption
    means the position is lost and the consumer must catch up from a
    checkpoint."""


class FrameSchemaError(WireError):
    """The frame bytes are intact but not a decodable frame (unknown
    version or kind tag, payload is not an npz archive, required fields
    missing) — re-reading never helps; skip to a checkpoint."""


#: leading bytes of every framed payload ("Repro Key-sort Frame v1")
MAGIC = b"RKF1"

#: current header format version
WIRE_VERSION = 1

#: ``<`` magic(4s) version(B) kind(B) reserved(H) seq(Q) payload_len(Q) crc(I)
_HEADER = struct.Struct("<4sBBHQQI")

#: size in bytes of the fixed frame header
HEADER_SIZE = _HEADER.size


def _make_table() -> list[int]:
    # Castagnoli polynomial, reflected form (same table as iSCSI/ext4)
    poly = 0x82F63B78
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _make_table()


#: payloads from this many bytes up take the chunk-parallel evaluation:
#: the smallest size from which it was faster than the byte loop at every
#: larger size (``scripts/crc_crossover.py``; PERF.md gives the walls)
_PARALLEL_MIN = 1 << 10
#: how many chunks the parallel evaluation advances side by side
_PARALLEL_CHUNKS = 1 << 14


def _crc_bytes(reg: int, data) -> int:
    """The raw CRC register after ``data`` (no pre- or post-inversion)."""
    table = _TABLE
    for b in memoryview(data).cast("B"):
        reg = table[(reg ^ b) & 0xFF] ^ (reg >> 8)
    return reg


def _apply(cols: list[int], v: int) -> int:
    """A linear map on 32-bit registers (``cols[i]`` = image of bit i)."""
    out = 0
    i = 0
    while v:
        if v & 1:
            out ^= cols[i]
        v >>= 1
        i += 1
    return out


def _zeros_operator(n_bytes: int) -> list[int]:
    """The register map of ``n_bytes`` zero bytes, by repeated squaring
    of the one-byte map (the register update is linear over GF(2))."""
    step = [_TABLE[(1 << i) & 0xFF] ^ ((1 << i) >> 8) for i in range(32)]
    out = [1 << i for i in range(32)]
    while n_bytes:
        if n_bytes & 1:
            out = [_apply(step, c) for c in out]
        step = [_apply(step, c) for c in step]
        n_bytes >>= 1
    return out


def _slice4_tables() -> np.ndarray:
    """Slicing-by-4 tables: row k is a byte's effect followed by k zero
    bytes."""
    t = np.zeros((4, 256), np.uint32)
    t[0] = _TABLE
    for k in range(1, 4):
        prev = t[k - 1]
        t[k] = (prev >> np.uint32(8)) ^ t[0][prev & np.uint32(0xFF)]
    return t


_SLICE4 = _slice4_tables()


@functools.lru_cache(maxsize=8)
def _zeros_tables(n_bytes: int) -> tuple[list[int], ...]:
    """The zeros map of ``n_bytes`` as four byte tables (one per byte of
    the register); a chunk length recurs from frame to frame."""
    zmap = _zeros_operator(n_bytes)
    return tuple([_apply(zmap, v << (8 * j)) for v in range(256)] for j in range(4))


def _crc_parallel(reg: int, data, n_chunks: int = _PARALLEL_CHUNKS) -> int:
    """The raw register after ``data``, with ``n_chunks`` equal chunks
    advanced side by side in numpy (four bytes a step, slicing-by-4) and
    their registers combined in order: the register after chunk i from
    state s is the zeros map of the chunk's length applied to s, XOR the
    chunk's register from 0.  The bytes past the last whole chunk take
    the byte loop."""
    buf = memoryview(data).cast("B")
    n = len(buf)
    size = max(4, (n // n_chunks) & ~3)
    k = n // size
    words = np.frombuffer(buf[: k * size], dtype="<u4").reshape(k, size // 4)
    cols = np.ascontiguousarray(words.T)
    t0, t1, t2, t3 = _SLICE4
    byte = np.uint32(0xFF)
    regs = np.zeros(k, np.uint32)
    for col in cols:
        c = regs ^ col
        regs = (t3[c & byte] ^ t2[(c >> np.uint32(8)) & byte]
                ^ t1[(c >> np.uint32(16)) & byte] ^ t0[c >> np.uint32(24)])
    z0, z1, z2, z3 = _zeros_tables(size)
    for r in regs.tolist():
        reg = (z0[reg & 0xFF] ^ z1[(reg >> 8) & 0xFF] ^ z2[(reg >> 16) & 0xFF]
               ^ z3[reg >> 24] ^ r)
    return _crc_bytes(reg, buf[k * size:])


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C (Castagnoli) of ``data``; chainable via the ``crc`` seed.

    Payloads of at least ``_PARALLEL_MIN`` bytes take the chunk-parallel
    evaluation; both give the same value."""
    reg = crc ^ 0xFFFFFFFF
    if len(memoryview(data).cast("B")) >= _PARALLEL_MIN:
        reg = _crc_parallel(reg, data)
    else:
        reg = _crc_bytes(reg, data)
    return reg ^ 0xFFFFFFFF


@dataclass(frozen=True)
class FrameHeader:
    """The decoded fixed header of a framed payload.

    ``kind`` is the numeric frame-kind tag (the stream layer maps it to
    the frame dataclasses); ``seq`` is the publisher's monotonic frame
    counter — independent of transport positions, so a reader can detect
    wire-level reordering/duplication even after retention renumbered
    nothing (positions are never reused, but a chaos wire can still
    deliver them out of order).
    """

    version: int
    kind: int
    seq: int
    payload_len: int
    crc: int


def _body_crc(version: int, kind: int, seq: int, payload: bytes) -> int:
    # the checksum covers the load-bearing header fields + payload, so a
    # bit flip anywhere past the magic is caught by one comparison
    head = struct.pack("<BBHQQ", version, kind, 0, seq, len(payload))
    return crc32c(payload, crc=crc32c(head))


def is_framed(buf: bytes) -> bool:
    """Whether ``buf`` starts with the v1 frame magic (else: legacy v0)."""
    return bytes(buf[:4]) == MAGIC


def pack_frame(kind: int, payload: bytes, seq: int = 0) -> bytes:
    """Wrap ``payload`` in a v1 integrity header; inverse of ``unpack_frame``."""
    if not 0 <= int(kind) <= 0xFF:
        raise ValueError(f"frame kind tag out of range: {kind}")
    crc = _body_crc(WIRE_VERSION, kind, seq, payload)
    return (
        _HEADER.pack(MAGIC, WIRE_VERSION, kind, 0, seq, len(payload), crc)
        + payload
    )


def unpack_frame(buf: bytes) -> tuple[FrameHeader, bytes]:
    """Verify and split a framed payload into ``(header, payload)``.

    Raises :class:`FrameCorrupt` on damage (short buffer, length
    mismatch, checksum mismatch) and :class:`FrameSchemaError` on an
    unknown magic or format version.
    """
    buf = bytes(buf)
    if len(buf) < HEADER_SIZE:
        raise FrameCorrupt(
            f"frame shorter than its header ({len(buf)} < {HEADER_SIZE} bytes)"
        )
    magic, version, kind, _res, seq, plen, crc = _HEADER.unpack_from(buf)
    if magic != MAGIC:
        raise FrameSchemaError(f"bad frame magic {magic!r}")
    if version != WIRE_VERSION:
        raise FrameSchemaError(f"unknown wire format version {version}")
    payload = buf[HEADER_SIZE:]
    if len(payload) != plen:
        raise FrameCorrupt(
            f"frame payload length {len(payload)} != header's {plen} "
            "(truncated or padded)"
        )
    if _body_crc(version, kind, seq, payload) != crc:
        raise FrameCorrupt("frame checksum mismatch (CRC32C)")
    return FrameHeader(version, kind, seq, plen, crc), payload
