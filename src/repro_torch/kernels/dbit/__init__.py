from .ops import (  # noqa: F401
    SECTOR_WORDS,
    adjacent_dbitmap,
    adjacent_dbitmap_plain,
    adjacent_dbits,
    adjacent_dbits_plain,
)
