"""The port's checkpoints against the JAX reference's, on the CPU.

``repro_torch.ckpt`` writes what ``repro.ckpt.checkpoint`` writes: the
same leaf files (``leaf_{i:06d}.npy`` in the reference's flattening
order), the same manifest keys (the FNV-1a hash of each leaf's path), the
same DS-metadata and delta logs; so a full step and a chain of delta
steps saved by either package restore in the other, leaf for leaf, with
the same manifest index path (incremental or not).  The flattening is
held against ``jax.tree_util`` on a tree of dicts, lists, tuples, a named
tuple and ``None``.  The manifest index is reconstructed on ``"torch"``
and ``"cuda"`` (``device="cpu"``); a restore to a device returns tensors.
"""

import collections
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.ckpt import checkpoint as rckpt  # noqa: E402
from repro_torch.ckpt import (  # noqa: E402
    CheckpointIndex,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    save_checkpoint_delta,
    step_manifest,
)
from repro_torch.ckpt import checkpoint as pckpt  # noqa: E402

PORT_BACKENDS = ("torch", "cuda")
Pair = collections.namedtuple("Pair", "left right")


def _jax_names(tree) -> list[str]:
    return ["/".join(str(p.key) if hasattr(p, "key") else str(p) for p in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_flattening_matches_jax_tree_util():
    tree = {"z": np.arange(3), "a": [np.ones(2), (np.zeros(1), None, {"q": 4.0, "b": 5})],
            "nt": Pair(np.int32(5), [6, 7]), "none": None,
            "od": collections.OrderedDict([("y", 1), ("x", 2)])}
    names = [n for n, _ in pckpt._flatten(tree)]
    assert names == _jax_names(tree)
    # int keys sort as ints and name as str(key)
    assert [n for n, _ in pckpt._flatten({10: 1, 2: 2})] == _jax_names({10: 1, 2: 2})
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]
    for (_, got), want in zip(pckpt._flatten(tree), leaves):
        np.testing.assert_array_equal(got, want)
    rebuilt = pckpt._unflatten(tree, iter(range(len(leaves))))
    want = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tree),
                                        list(range(len(leaves))))
    assert jax.tree_util.tree_structure(rebuilt) == jax.tree_util.tree_structure(want)
    assert jax.tree_util.tree_leaves(rebuilt) == jax.tree_util.tree_leaves(want)
    assert isinstance(rebuilt["nt"], Pair) and rebuilt["none"] is None


def _trees():
    """A full step's tree and two delta steps' (a changed leaf; a changed
    leaf, a new leaf and a removed one), uint32 leaves among them."""
    rng = np.random.default_rng(1)
    t1 = {
        "wte": rng.normal(size=(16, 8)).astype(np.float32),
        "block": {"w1": rng.normal(size=(8, 8)).astype(np.float32),
                  "w2": rng.normal(size=(8,)).astype(np.float32)},
        "keyset": {"words": rng.integers(0, 2**32, (50, 3), dtype=np.uint32),
                   "rids": np.arange(50, dtype=np.uint32)},
        "layers": [np.int32(3), np.arange(4, dtype=np.int64)],
    }
    t2 = {**t1, "wte": t1["wte"] + 1}
    t3 = {**t2, "block": {"w1": t2["block"]["w1"] * 2, "w3": np.ones(3, np.float32)}}
    return t1, t2, t3


def _save_chain(mod, root, trees, **kw):
    mod.save_checkpoint(root, 1, trees[0], extra_meta={"snapshot_epoch": 4}, **kw)
    mod.save_checkpoint_delta(root, 2, trees[1], base_step=1)
    mod.save_checkpoint_delta(root, 3, trees[2], base_step=2, extra_meta={"tag": "x"})


def _npz(path) -> dict:
    with np.load(path) as z:
        return dict(z)


def _assert_trees_equal(got, want):
    gl, wl = pckpt._flatten(got), pckpt._flatten(want)
    assert [n for n, _ in gl] == [n for n, _ in wl]
    for (name, g), (_, w) in zip(gl, wl):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """The same three steps saved by the reference and by the port."""
    trees = _trees()
    ref_dir = tmp_path_factory.mktemp("ref")
    port_dir = tmp_path_factory.mktemp("port")
    _save_chain(rckpt, ref_dir, trees)
    _save_chain(pckpt, port_dir, trees, device="cpu")
    return trees, ref_dir, port_dir


def test_saved_steps_equal_the_references(chains):
    """Leaf files byte for byte, manifests, DS-metadata, delta logs and
    ``meta.json`` alike; so are ``latest_step``, ``step_manifest`` and the
    host-side manifest view of every step."""
    _, ref_dir, port_dir = chains
    for step in (1, 2, 3):
        rd, pd = ref_dir / f"step_{step:08d}", port_dir / f"step_{step:08d}"
        assert sorted(p.name for p in rd.iterdir()) == sorted(p.name for p in pd.iterdir())
        for f in rd.iterdir():
            if f.suffix == ".npy":
                assert f.read_bytes() == (pd / f.name).read_bytes(), f.name
            elif f.suffix == ".npz":
                got, want = _npz(pd / f.name), _npz(f)
                assert got.keys() == want.keys()
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k], err_msg=f"{f.name}:{k}")
            else:
                assert json.loads(f.read_text() if f.name != "DONE" else "0") == \
                    json.loads((pd / f.name).read_text() if f.name != "DONE" else "0")
        want_man = rckpt.step_manifest(ref_dir, step)
        got_man = step_manifest(port_dir, step)
        assert {k: v for k, v in got_man.items() if k != "ckpt_dir"} == \
            {k: v for k, v in want_man.items() if k != "ckpt_dir"}
        for g, w in zip(pckpt._manifest_view(port_dir, step),
                        rckpt._manifest_view(ref_dir, step)):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert latest_step(port_dir) == rckpt.latest_step(ref_dir) == 3


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_reference_checkpoints_restore_in_the_port(chains, backend):
    trees, ref_dir, _ = chains
    paths = []
    for step, tree in zip((1, 2, 3), trees):
        like = jax.tree_util.tree_map(np.zeros_like, tree)
        got, stats = restore_checkpoint(ref_dir, step, like, backend=backend,
                                        index_device="cpu")
        _, want = rckpt.restore_checkpoint(ref_dir, step, like)
        _assert_trees_equal(got, tree)
        for key in ("n_leaves", "index_height", "compression_ratio", "incremental",
                    "snapshot_epoch", "meta"):
            assert stats[key] == want[key], (step, key)
        assert stats["index_backend"] == backend
        paths.append(stats["incremental"])
    # step 2 replays its log incrementally; step 3's new leaf key sets a
    # new distinction bit, so its index takes the full rebuild
    assert paths == [False, True, False]


def test_port_checkpoints_restore_in_the_reference(chains):
    trees, _, port_dir = chains
    for step, tree in zip((1, 2, 3), trees):
        like = jax.tree_util.tree_map(np.zeros_like, tree)
        got, stats = rckpt.restore_checkpoint(port_dir, step, like)
        _assert_trees_equal(got, tree)
        assert stats["meta"]["step"] == step
        assert stats["snapshot_epoch"] == (4 if step == 1 else 0)


def test_restore_to_a_device_and_the_index(chains):
    """``device=`` returns tensors (uint32 leaves as int64 carriers); the
    manifest index answers by path and raises ``KeyError`` for others; an
    uncommitted step neither restores nor counts as the latest."""
    trees, _, port_dir = chains
    got, _ = restore_checkpoint(port_dir, 3, trees[2], device="cpu", index_device="cpu")
    assert got["keyset"]["words"].dtype == torch.int64
    np.testing.assert_array_equal(got["keyset"]["words"].numpy().astype(np.uint32),
                                  trees[2]["keyset"]["words"])
    assert got["wte"].dtype == torch.float32 and isinstance(got["layers"], list)
    idx = CheckpointIndex(port_dir / "step_00000003", backend="cuda", device="cpu")
    assert idx.lookup("block/w3").startswith("leaf_")
    assert idx.lookup("wte") == "../step_00000002/leaf_000000.npy"
    with pytest.raises(KeyError):
        idx.lookup("block/w2")  # removed by step 3
    (port_dir / ".tmp_step_00000009").mkdir()
    (port_dir / "step_00000008").mkdir()  # no DONE marker: a torn save
    assert latest_step(port_dir) == 3
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(port_dir, 8, trees[2], index_device="cpu")
    with pytest.raises(FileNotFoundError):
        save_checkpoint_delta(port_dir, 10, trees[2], base_step=8)
    save_checkpoint(port_dir, 11, {"only": np.ones(2)}, device="cpu")
    assert latest_step(port_dir) == 11
