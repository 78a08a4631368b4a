"""Wire integrity for stream frames: CRC32C-framed headers, typed errors.

A copy of the reference's ``replication/wire.py`` (``struct`` only).
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

CRC32C (Castagnoli) is computed with a table-driven pure-Python loop —
no new dependency, and frame payloads are small (KBs of change-log
columns); the checksum choice matches what storage/wire protocols
(iSCSI, ext4, gRPC) use, so captured frames verify with standard tools.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

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


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C (Castagnoli) of ``data``; chainable via the ``crc`` seed."""
    crc ^= 0xFFFFFFFF
    table = _TABLE
    for b in memoryview(data):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


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
