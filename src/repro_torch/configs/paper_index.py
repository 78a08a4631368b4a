"""The paper's own workload configs: the six datasets of Table 2 (synthetic
stand-ins matching published statistics) and the Zipf(s, n, m) sensitivity
generator of §6.3 (fully specified in the paper, so Table 4's sort-key
ratios are *reproducible exactly*)."""

from dataclasses import dataclass


@dataclass(frozen=True)
class IndexDatasetConfig:
    name: str
    n_keys: int  # scaled down from the paper for CPU benching
    key_bytes: int  # fixed width (or max width) per paper Table 2
    kind: str  # "fixed" | "zipf" | "url" | "title"
    zipf_s: float = 1.5
    zipf_m: int = 0  # leading constant bytes per 8-byte word (paper §6.3)


# Paper Table 2 stand-ins (n scaled ~1/64 for CPU wall-clock; the *ratios*
# —compression, sort-key, word-comparison— are size-independent).
DATASETS = {
    "INDBTAB": IndexDatasetConfig("INDBTAB", 256_000, 35, "fixed"),
    "Human": IndexDatasetConfig("Human", 570_000, 101, "genome"),
    "Wikititle": IndexDatasetConfig("Wikititle", 218_000, 24, "title"),
    "ExURL": IndexDatasetConfig("ExURL", 120_000, 59, "url"),
    "WikiURL": IndexDatasetConfig("WikiURL", 200_000, 50, "url"),
    "Part": IndexDatasetConfig("Part", 31_000, 34, "fixed"),
}


@dataclass(frozen=True)
class ZipfConfig:
    """Zipf(s, n, m) of §6.3: keys of n bytes; in each 8-byte word the first
    m bytes are a constant, the rest lower-case ASCII ~ Zipf(s, 26)."""

    s: float
    n_bytes: int
    m: int
    n_keys: int = 100_000  # paper uses 10M; ratios are size-independent


# Table 4 rows (datasets 1-20)
ZIPF_TABLE4 = [
    *(ZipfConfig(2.5, n, 0) for n in (48, 56, 64, 72, 80, 88, 96, 104, 112)),
    *(ZipfConfig(1.5, 40, m) for m in range(5)),
    *(ZipfConfig(1.5, 64, m) for m in range(6)),
]
