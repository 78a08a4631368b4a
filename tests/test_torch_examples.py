"""The port's example twins on the CPU, each at its fast setting with
``--device cpu``, checked for what its run shows.

* ``examples/train_lm_torch.py --quick``: 30 steps with checkpoints at 25
  and 30, finite losses; with step 30's checkpoint gone, a second run
  resumes from 25 and its losses equal the first run's within 1e-4
  relative (the CPU's threaded embedding-gradient sums may reorder).  The
  model is repro-100m at ``reduced()`` widths with its own attention and
  loss chunks (128), so the 30 steps fit a test;
* ``examples/serve_moe_torch.py``: 16 tokens for 4 sequences, a restart
  that rebuilds the page index, and sequence 2's page 1 found through the
  index at the page the table holds;
* ``examples/replication_torch.py --fast``: replica B caught up through
  the checkpoint chain, A, B and the primary byte-identical, a probe
  answered alike by all three.
"""

import dataclasses
import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import train as launch_train  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _twin(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_train_lm_twin_trains_checkpoints_and_resumes(tmp_path, monkeypatch):
    small = dataclasses.replace(launch_train.REPRO_100M.reduced(), q_chunk=128,
                                kv_chunk=128, loss_chunk=128)
    monkeypatch.setattr(launch_train, "resolve_arch", lambda name, reduced: small)
    twin = _twin("train_lm_torch")
    argv = ["--quick", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    first = twin.main(argv)
    assert first["restored"] is None
    assert [s["step"] for s in first["saves"]] == [25, 30]
    assert sorted(first["losses"]) == list(range(1, 31))
    assert all(np.isfinite(float(v)) for v in first["losses"].values())
    shutil.rmtree(tmp_path / "step_00000030")
    second = twin.main(argv)
    assert second["restored"]["meta"]["step"] == 25
    assert sorted(second["losses"]) == list(range(26, 31))
    for step, loss in second["losses"].items():
        want = float(first["losses"][step])
        assert abs(float(loss) - want) <= 1e-4 * abs(want), step


def test_serve_moe_twin_generates_restarts_and_finds_a_page():
    out = _twin("serve_moe_torch").main(["--device", "cpu"])
    assert out["tokens"].shape == (4, 16)
    st = out["restart"]
    assert st["index_height"] >= 1 and st["compression_ratio"] > 1
    table = out["engine"].pager._table
    assert out["page"] is not None and out["page"] == table[(2, 1)]


def test_replication_twin_ends_byte_identical():
    out = _twin("replication_torch").main(["--fast", "--device", "cpu"])
    assert out["catchup"] is True
    assert out["a_equals_b"] and out["a_equals_primary"]
    assert out["probe"][0] == out["probe"][1] == out["probe"][2]
    assert out["probe"][0][0] is True
