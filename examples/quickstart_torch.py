"""Quickstart on the PyTorch + CUDA port: build a compressed-key index over a
synthetic table, search it, mutate it online, and reconstruct it — the
paper's full lifecycle, on the GPU through the hand-written kernels.

  PYTHONPATH=src python examples/quickstart_torch.py              # the GPU
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu # the host

The twin of ``examples/quickstart.py``.  ``--device cpu`` runs the same
``"cuda"`` backend with every kernel's plain version.
"""

import argparse

import numpy as np

from repro_torch.core.index import OnlineIndex
from repro_torch.core.keyformat import (
    encode_int32,
    encode_multicolumn,
    encode_varchar,
    keys_to_words,
)
from repro_torch.core.reconstruct import full_key_reconstruct, reconstruct_index


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = args.device
    rng = np.random.default_rng(0)

    # 1. a table with a multi-column index key: (PART int, NAME varchar(30))
    print("== building a 20k-row table ==")
    names = sorted(
        {
            "".join(chr(97 + c) for c in rng.integers(0, 26, rng.integers(4, 12)))
            for _ in range(20_000)
        }
    )
    keys = [
        encode_multicolumn([encode_int32(i % 997), encode_varchar(nm, 30)])
        for i, nm in enumerate(names)
    ]
    table = keys_to_words(keys)
    print(f"   {table.n} keys, {table.n_words * 4} bytes padded width")

    # 2. reconstruct the index with the compressed key sort
    reconstruct_index(table, device=dev)  # warm-up (kernel build, allocator)
    full_key_reconstruct(table, device=dev)
    res = reconstruct_index(table, device=dev)
    s = res.stats
    print(f"== compressed key sort reconstruction on {s['device']} ==")
    print(f"   distinction bits: {s['distinction_bits']} / {s['full_key_bits']}"
          f"  (compression {s['compression_ratio']:.2f}:1)")
    print(f"   sort key: {s['comp_sort_key_words']} words vs "
          f"{s['full_sort_key_words']} uncompressed "
          f"(ratio {s['sort_key_ratio']:.2f})")
    print(f"   tree: height {s['tree_height']}, {s['tree_bytes']/1024:.0f} KiB")
    print(f"   phases: extract {res.timings['extract']*1e3:.1f}ms, "
          f"sort {res.timings['sort']*1e3:.1f}ms, "
          f"build {res.timings['build']*1e3:.1f}ms")

    full = full_key_reconstruct(table, device=dev)
    print(f"   full-key baseline total: {full.timings['total']*1e3:.1f}ms vs "
          f"compressed {res.timings['total']*1e3:.1f}ms")

    # 3. point lookups through the online index (the backend's lookup)
    oi = OnlineIndex(keyset=table, result=res, device=dev)
    found, rid = oi.search_batch(table.words[:1000])
    assert found.all() and (rid == table.rids[:1000]).all()
    print(f"== search == {int(found.sum())}/1000 hits (expect 1000)")

    # 4. online mutations + rebuild with lazily-stale metadata
    newkey = np.asarray(
        keys_to_words(
            [encode_multicolumn([encode_int32(42), encode_varchar("zzz_new", 30)])],
            n_words=table.n_words,
        ).words[0]
    )
    oi.insert(newkey, rid=999_999)
    assert oi.search(newkey) == (True, 999_999)
    assert oi.delete(np.asarray(table.words[7]))
    oi2 = oi.rebuild()
    assert oi2.search(newkey) == (True, 999_999)
    assert not oi2.search(np.asarray(table.words[7]))[0]
    merged = "merged the delta" if oi2.result.stats["incremental"] else "full resort"
    print(f"== online ==  insert+delete+rebuild OK ({merged}; "
          f"bitmap bits {oi.meta.n_dbits} -> {oi2.meta.n_dbits} after rebuild)")


if __name__ == "__main__":
    main()
