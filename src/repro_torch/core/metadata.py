"""DS-metadata (paper §4.2–4.3): the only persistent state for an index.

``{D-bitmap, variant bitmap, reference key}`` — everything else (the sorted
order, the tree) is reconstructed from the base table.  The update rules and
their correctness arguments are implemented exactly:

* **insert** K between A and B: by Lemma 1, D-bit(A,B) = min(D(A,K), D(K,B))
  and is already set, so only ``max(D(A,K), D(K,B))`` needs setting; the
  variant bitmap ORs in ``K XOR reference``.
* **delete**: *no change* — by Lemma 1 the surviving pair's distinction bit
  is the min of the two removed pairs' bits, both already set.  Stale 1-bits
  are harmless by Theorem 2 (extended distinction bit positions).
* **rebuild**: compute the bitmap anew from adjacent compressed keys; bits
  that were 0 stay 0, stale bits are shed.

The *update rules* (``meta_on_insert`` etc.) are host-side scalar work
(numpy) — they sit on the DB transaction path.  The *rebuild-time refresh*
reduces the adjacent D-bits of the sorted compressed run to a bitmap in
the compressed bit space on the device (the backends' ``refresh_meta`` op
feeds its words in via ``dbitmap_comp``); here on the host only its set
bits, at most 32 per word, are mapped through D-offset.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from .compress import ExtractionPlan, make_plan

__all__ = [
    "DSMeta",
    "meta_from_keys",
    "meta_on_insert",
    "meta_on_delete",
    "meta_on_rebuild",
    "shed_or_pin",
]


def _np_dbit(a: np.ndarray, b: np.ndarray) -> int:
    """Distinction bit position of two (W,) uint32 keys; -1 if equal."""
    x = (np.asarray(a, np.uint32) ^ np.asarray(b, np.uint32)).astype(np.uint32)
    nz = np.nonzero(x)[0]
    if nz.size == 0:
        return -1
    w = int(nz[0])
    v = int(x[w])
    return w * 32 + (31 - v.bit_length() + 1)


def _set_bit(bitmap: np.ndarray, pos: int) -> np.ndarray:
    out = bitmap.copy()
    out[pos // 32] |= np.uint32(1) << np.uint32(31 - pos % 32)
    return out


@dataclass(frozen=True)
class DSMeta:
    """Persistent DS-metadata for one index (host-side numpy)."""

    dbitmap: np.ndarray  # (W,) uint32 — extended distinction bit positions
    varbitmap: np.ndarray  # (W,) uint32 — extended variant bit positions
    refkey: np.ndarray  # (W,) uint32 — any member key (invariant-bit source)
    n_words: int

    def plan(self) -> ExtractionPlan:
        return make_plan(self.dbitmap, self.n_words)

    @property
    def n_dbits(self) -> int:
        return int(sum(bin(int(w)).count("1") for w in self.dbitmap))

    @property
    def compression_ratio(self) -> float:
        return (self.n_words * 32) / max(self.n_dbits, 1)

    def d_offset(self) -> np.ndarray:
        """D-offset[i] = full-key position of the (i+1)-st 1 in the D-bitmap
        (paper §5.3) — maps compressed-key bit positions back to full-key
        positions for distinction-bit fields in tree entries."""
        from .dbits import dbit_positions_nonempty

        return dbit_positions_nonempty(self.dbitmap)

    # -- serialization (checkpoint manifest / replication payload) ----------
    def to_npz_dict(self) -> dict[str, np.ndarray]:
        return {
            "dbitmap": self.dbitmap,
            "varbitmap": self.varbitmap,
            "refkey": self.refkey,
            "n_words": np.asarray(self.n_words, np.int32),
        }

    @staticmethod
    def from_npz_dict(d: dict[str, np.ndarray]) -> "DSMeta":
        return DSMeta(
            dbitmap=np.asarray(d["dbitmap"], np.uint32),
            varbitmap=np.asarray(d["varbitmap"], np.uint32),
            refkey=np.asarray(d["refkey"], np.uint32),
            n_words=int(d["n_words"]),
        )


def meta_from_keys(words: np.ndarray, device=None, dbitmap_fn=None) -> DSMeta:
    """Initial DS-metadata from full index keys (first-time build, §4.3).

    The sort behind the D-bitmap runs on ``device`` (CUDA unless the
    caller names another); the result is host-side numpy.
    ``dbitmap_fn(sorted_words) -> (W,)`` is the adjacent-pair bitmap pass
    over the sorted keys (a backend's ``dbitmap_fn``; default: the plain
    pass of ``compute_dbitmap``).
    """
    from .dbits import compute_dbitmap, compute_variant_bitmap
    from .u32 import resolve_device, to_carrier, to_u32

    w = to_carrier(np.asarray(words, np.uint32), resolve_device(device))
    var, ref = compute_variant_bitmap(w)
    return DSMeta(
        dbitmap=to_u32(compute_dbitmap(w, dbitmap_fn=dbitmap_fn)),
        varbitmap=to_u32(var),
        refkey=to_u32(ref),
        n_words=int(w.shape[1]),
    )


def meta_on_insert(meta: DSMeta, prev_key: np.ndarray | None, new_key: np.ndarray,
                   next_key: np.ndarray | None) -> DSMeta:
    """Insert K between neighbors A (prev) and B (next); either may be absent
    at the extremes of the key range."""
    candidates = []
    for nb in (prev_key, next_key):
        if nb is not None:
            d = _np_dbit(nb, new_key)
            if d >= 0:
                candidates.append(d)
    dbm = meta.dbitmap
    if candidates:
        # Lemma 1: min(D(A,K), D(K,B)) == D(A,B), already set; set the max.
        dbm = _set_bit(dbm, max(candidates))
    var = meta.varbitmap | (np.asarray(new_key, np.uint32) ^ meta.refkey)
    return replace(meta, dbitmap=dbm, varbitmap=var)


def meta_on_delete(meta: DSMeta) -> DSMeta:
    """Deletes leave the bitmaps untouched (lazy; valid by Theorem 2)."""
    return meta


def meta_on_rebuild(
    comp_sorted: np.ndarray,
    old_meta: DSMeta,
    ref_full_key: np.ndarray,
    dpos_comp: np.ndarray | None = None,
    *,
    dbitmap_comp: np.ndarray | None = None,
) -> DSMeta:
    """Recompute DS-metadata during index reconstruction (§4.3).

    The new D-bitmap comes from adjacent *compressed* keys mapped through
    D-offset: stale bits (0 adjacency in the compressed space) are shed and
    bits that were 0 stay 0.  The variant bitmap is rebuilt from the same
    pass over the table (done by the caller who still holds full keys;
    here we accept the compressed adjacency only).

    The bit set is one occupancy count over the bit positions packed into
    the 32-bit bitmap words (duplicate-safe and linear in the number of
    adjacencies), not a per-position Python loop.  ``dpos_comp``
    optionally carries precomputed adjacent D-bit positions;
    ``dbitmap_comp`` carries their OR instead, (Wc,) bitmap words in the
    compressed bit space — what the backends' refresh op
    (``repro_torch.core.plancache.adjacent_dbitmap_padded``) passes, so
    that only those words cross from the device.  D-offset is a function
    of the position alone, so mapping the bitmap's set bits gives the
    same bitmap as mapping every position.
    """
    from .dbits import NO_DBIT, bitmap_to_positions

    if dbitmap_comp is not None:
        dpos_comp = bitmap_to_positions(dbitmap_comp)
    elif dpos_comp is None:
        from .dbits import adjacent_dbit_positions
        from .u32 import to_carrier

        dpos_comp = adjacent_dbit_positions(
            to_carrier(np.asarray(comp_sorted, np.uint32), "cpu")
        ).numpy()
    dpos_comp = np.asarray(dpos_comp)
    d_off = old_meta.d_offset()
    valid = dpos_comp != NO_DBIT
    full_pos = d_off[dpos_comp[valid]]
    n_bits = old_meta.dbitmap.shape[0] * 32
    occ = np.bincount(full_pos, minlength=n_bits)[:n_bits] > 0
    dbm = np.packbits(occ).view(">u4").astype(np.uint32)
    return replace(old_meta, dbitmap=dbm, refkey=np.asarray(ref_full_key, np.uint32))


def shed_or_pin(
    refreshed_meta: DSMeta,
    extract_bitmap: np.ndarray,
    deletes_since_shed: int,
    shed_delete_frac: float | None,
    n_live: int,
) -> tuple[DSMeta, bool, int]:
    """The post-rebuild bitmap policy shared by Replica and the serve pager.

    Pinning the working D-bitmap to the *extraction* bitmap keeps
    consecutive rebuilds incremental (the standing sorted run can still be
    merged against), but lets delete-stale widened bits accumulate.  When
    the delete volume since the bits were last re-derived crosses
    ``shed_delete_frac`` of the live index, adopt the refreshed (shed)
    bitmap instead — the next rebuild pays one full resort under the
    narrower projection, then pinning resumes.  ``None`` never sheds.

    Returns ``(working_meta, shed, deletes_since_shed)``.
    """
    shed = (
        shed_delete_frac is not None
        and deletes_since_shed > shed_delete_frac * n_live
    )
    if shed:
        return refreshed_meta, True, 0
    pinned = replace(
        refreshed_meta, dbitmap=np.array(extract_bitmap, np.uint32, copy=True)
    )
    return pinned, False, deletes_since_shed
