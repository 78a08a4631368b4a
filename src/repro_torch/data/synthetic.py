"""Synthetic index datasets: the paper's generators (numpy, host side).

``zipf_keys`` implements Zipf(s, n, m) of §6.3 exactly as the reference
package does (same ``default_rng`` draw order, so a seed gives the same
keys in both packages): within each 8-byte word the first m bytes are a
fixed ASCII value and the remaining 8-m bytes are lower-case ASCII drawn
from Zipf(s, 26).  Duplicate keys are removed, which sorts the rows.

Two steps are vectorized where the reference loops in Python, with
byte-identical output: the row dedupe compares each 64-byte row as one
opaque ``void`` item (memcmp order == the byte-lexicographic order of a
row-wise ``np.unique``), and the rows are packed into big-endian words
straight from the ``uint8`` buffer instead of one ``bytes`` object per key.
At the paper's 10M keys that turns minutes of host time into seconds.

``dataset_keys`` builds the Table-2 stand-ins (fixed records, URLs,
titles, genome reads) with the reference's generators, and ``lm_tokens``
the training path's Zipf token corpus, the same bytes for the same seed.
"""

from __future__ import annotations

import numpy as np

from repro_torch.configs.paper_index import IndexDatasetConfig, ZipfConfig
from repro_torch.core.keyformat import KeySet, keys_to_words

__all__ = ["zipf_keys", "dataset_keys", "rows_to_keyset", "lm_tokens"]


def _zipf_choice(rng: np.random.Generator, s: float, k: int, size) -> np.ndarray:
    """Draw from Zipf(s) truncated to {0..k-1} (paper's Zipf(s, 26))."""
    ranks = np.arange(1, k + 1, dtype=np.float64)
    p = ranks ** (-s)
    p /= p.sum()
    return rng.choice(k, size=size, p=p)


def _unique_rows(buf: np.ndarray) -> np.ndarray:
    """``np.unique(buf, axis=0)`` for a (n, B) uint8 buffer, via one void
    item per row: the same rows in the same (byte-lexicographic) order."""
    n, width = buf.shape
    rows = np.ascontiguousarray(buf).view(np.dtype((np.void, width))).ravel()
    return np.unique(rows).view(np.uint8).reshape(-1, width)


def rows_to_keyset(buf: np.ndarray) -> KeySet:
    """Pack a (n, B) uint8 buffer of equal-length keys (B a multiple of 4)
    into a KeySet — byte-identical to ``keys_to_words`` over its rows."""
    n, width = buf.shape
    if width % 4:
        raise ValueError(f"key width {width} is not a whole number of words")
    words = np.ascontiguousarray(buf).view(">u4").astype(np.uint32)
    return KeySet(
        words=words.reshape(n, width // 4),
        lengths=np.full((n,), width, np.int32),
        rids=np.arange(n, dtype=np.uint32),
    )


def zipf_keys(cfg: ZipfConfig, seed: int = 0, unique: bool = True) -> KeySet:
    """Zipf(s, n, m) keys of §6.3, packed (rows sorted when ``unique``)."""
    if cfg.n_bytes % 8:
        raise ValueError("the paper's generator uses whole 8-byte words")
    rng = np.random.default_rng(seed)
    fixed = ord("a")  # "an arbitrary fixed character"
    buf = np.empty((cfg.n_keys, cfg.n_bytes), dtype=np.uint8)
    for w in range(cfg.n_bytes // 8):
        lo = w * 8
        buf[:, lo : lo + cfg.m] = fixed
        z = _zipf_choice(rng, cfg.s, 26, (cfg.n_keys, 8 - cfg.m))
        buf[:, lo + cfg.m : lo + 8] = ord("a") + z
    if unique:
        buf = _unique_rows(buf)
    return rows_to_keyset(buf)


def _url_like(rng, n, avg_len, max_len):
    """Hierarchical URLs: deep shared prefixes, distinction bits near the
    tail (matches the real ExURL/WikiURL dbit spread, paper Table 2)."""
    n_dom = max(n // 400, 8)
    doms = [f"www.site{int(i):04d}.org" for i in range(n_dom)]
    segs = ["wiki", "pages", "article", "item", "data", "ref", "cat", "id"]
    out = set()
    while len(out) < n:
        d = doms[int(rng.integers(0, n_dom))]
        depth = int(rng.integers(1, 4))
        path = "/".join(
            f"{segs[int(rng.integers(0, len(segs)))]}{int(rng.integers(0, 50))}"
            for _ in range(depth)
        )
        leaf = "".join(chr(97 + c) for c in rng.integers(0, 26, rng.integers(3, 9)))
        out.add(f"http://{d}/{path}/{leaf}{int(rng.integers(0, 10**4))}"
                .encode()[:max_len])
    return list(out)


def _genome_reads(rng, n, read_len):
    """EST-like reads: deep-coverage loci with point errors, so adjacent
    sorted reads share long prefixes and distinction bits spread across the
    whole read (the Human dataset's broad dbit profile, paper Table 2)."""
    genome = rng.integers(0, 4, size=max(n * 2, 100_000))
    acgt = np.frombuffer(b"ACGT", np.uint8)
    loci = rng.integers(0, len(genome) - read_len, size=max(n // 12, 4))
    out = set()
    while len(out) < n:
        off = int(loci[int(rng.integers(0, len(loci)))])
        read = genome[off : off + read_len].copy()
        # ~3 sequencing errors per read, uniform over positions
        for _ in range(int(rng.poisson(3))):
            read[int(rng.integers(0, read_len))] = int(rng.integers(0, 4))
        out.add(bytes(acgt[read]))
    return list(out)


def _title_like(rng, n, max_len):
    words = ["".join(chr(97 + c) for c in rng.integers(0, 26, rng.integers(3, 9)))
             for _ in range(2000)]
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 4))
        t = "_".join(words[int(i)] for i in rng.integers(0, len(words), k))
        out.append(t.title().encode()[:max_len])
    return out


def _fixed_record(rng, n, width):
    """INDBTAB/Part-like: fixed-width multi-column business keys — a few
    low-cardinality columns + a sequence column (most bits invariant)."""
    out = np.zeros((n, width), dtype=np.uint8)
    out[:, :] = ord("0")
    doc = rng.integers(0, 10000, n)
    item = rng.integers(0, 100, n)
    seq = np.arange(n)
    for i in range(n):
        s = f"{2024:04d}{int(doc[i]):08d}{int(item[i]):04d}{int(seq[i]):010d}"
        b = s.encode()[:width]
        out[i, : len(b)] = np.frombuffer(b, np.uint8)
    return [bytes(r) for r in out]


def dataset_keys(cfg: IndexDatasetConfig, seed: int = 0) -> KeySet:
    """The Table-2 stand-in keys of ``cfg``, shuffled and packed."""
    rng = np.random.default_rng(seed)
    if cfg.kind == "fixed":
        keys = _fixed_record(rng, cfg.n_keys, cfg.key_bytes)
    elif cfg.kind == "url":
        keys = _url_like(rng, cfg.n_keys, cfg.key_bytes, cfg.key_bytes * 2)
    elif cfg.kind == "title":
        keys = _title_like(rng, cfg.n_keys, cfg.key_bytes * 3)
    elif cfg.kind == "genome":
        keys = _genome_reads(rng, cfg.n_keys, cfg.key_bytes)
    elif cfg.kind == "zipf":
        n8 = ((cfg.key_bytes + 7) // 8) * 8
        return zipf_keys(
            ZipfConfig(cfg.zipf_s, n8, cfg.zipf_m, cfg.n_keys), seed=seed
        )
    else:
        raise ValueError(cfg.kind)
    keys = sorted(set(keys))
    rng.shuffle(keys)
    return keys_to_words(keys)


def lm_tokens(n_docs: int, doc_len: int, vocab: int, seed: int = 0) -> np.ndarray:
    """Zipf-distributed synthetic token stream, (n_docs, doc_len) int32."""
    rng = np.random.default_rng(seed)
    return _zipf_choice(rng, 1.1, vocab, (n_docs, doc_len)).astype(np.int32)
