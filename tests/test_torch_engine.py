"""The port's serving engine against the JAX reference's, on the CPU.

``repro_torch.serve.engine.ServeEngine`` (``device="cpu"``, on the
``"torch"`` and the ``"cuda"`` pager backends: every kernel wrapper takes
its plain version on a CPU tensor) and ``repro.serve.engine.ServeEngine``
serve the same reduced llama3-8b, the reference's parameters carried over
with ``lm_params_from_numpy``, at ``compute_dtype=float32``: greedy tokens
must be equal, and so must the pager table, free list and drained
journal (its wire bytes), the integer fields of every restart (the first
build and the incremental one), a following standby's restart over each
package's stream and every page get.  Sampled tokens come from a seeded
``torch.Generator`` and cannot equal the reference's draws from its own
generator; they are held to their shape, range and seed.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.core.snapshot import AdmissionShed as RAdmissionShed  # noqa: E402
from repro.models.lm import LM as RefLM  # noqa: E402
from repro.replication import QueueTransport as RQueueTransport  # noqa: E402
from repro.replication import StreamPrimary as RStreamPrimary  # noqa: E402
from repro.replication import StreamReplica as RStreamReplica  # noqa: E402
from repro.serve.engine import ServeEngine as RefEngine  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.core.snapshot import AdmissionShed  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.replication import QueueTransport, StreamPrimary, StreamReplica  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

B, T, N_NEW = 2, 16, 8
ENGINE = dict(max_seq=64, batch_size=B, page_tokens=16)
#: the integer (and exact) fields of a restart's report
RESTART_FIELDS = ("index_height", "compression_ratio", "snapshot_epoch", "incremental",
                  "fallback", "log_entries_replayed", "shed_bits")
STANDBY_FIELDS = ("index_height", "followed_stream", "applied_lsn", "lag_frames", "catchup",
                  "incremental", "log_entries_replayed", "snapshot_epoch")
#: every (seq, page) the scenario maps, and some it never does
PROBE = [(s, p) for s in range(B + 1) for p in range(ENGINE["max_seq"] // 16 + 1)]


def _scenario(make_engine, primary_stream, standby_stream, prompts, extras=None) -> dict:
    """Drive a primary and a following standby: generate, restart; free a
    sequence and admit it again (no new distinction bit: the restart folds
    the journal incrementally); grow the other past its pages (a new bit:
    the restart falls back to the full build); record what both packages
    must agree on after each step."""
    primary = make_engine()
    primary.pager.attach_stream(primary_stream)
    standby = make_engine()
    standby.follow(standby_stream)
    out = {"tokens": primary.generate(prompts, N_NEW, extras=extras)}
    pm = primary.pager
    out["table"] = list(pm._table.items())
    out["free"] = list(pm._free)
    out["journal"] = pm._log.to_wire()
    churn = {2: lambda: (pm.free_seq(1), pm.pages_for(1, T + N_NEW)),
             3: lambda: pm.pages_for(0, ENGINE["max_seq"])}
    for r in (1, 2, 3):
        if r in churn:
            churn[r]()
            out[f"table_{r}"] = list(pm._table.items())
            out[f"journal_{r}"] = pm._log.to_wire()
        st = primary.restart()
        out[f"restart_{r}"] = {k: st[k] for k in RESTART_FIELDS}
        sst = standby.restart()
        out[f"standby_{r}"] = {k: sst[k] for k in STANDBY_FIELDS}
        out[f"gets_{r}"] = [primary.lookup_page(s, p) for s, p in PROBE]
        out[f"standby_gets_{r}"] = [standby.lookup_page(s, p) for s, p in PROBE]
    return out


def _prompts(cfg, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T))


_REF: dict = {}


def _reference(name: str) -> tuple:
    """The reference's scenario on a reduced arch at f32, run once."""
    if name not in _REF:
        cfg = REF_ARCHS[name].reduced()
        model = RefLM(cfg, compute_dtype=jnp.float32, remat=False)
        params = model.init(jax.random.PRNGKey(0))
        extras = _extras(cfg)
        t = RQueueTransport()
        out = _scenario(lambda: RefEngine(model, params, **ENGINE), RStreamPrimary(t, n_words=2),
                        RStreamReplica(t), _prompts(cfg), extras)
        _REF[name] = (jax.tree_util.tree_map(np.asarray, params), out)
    return _REF[name]


def _extras(cfg):
    if not cfg.n_img_tokens:
        return None
    rng = np.random.default_rng(1)
    return {"img_embeds": rng.normal(size=(B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)}


def _port_model(name: str, raw):
    model = LM(ARCHS[name].reduced(), compute_dtype=torch.float32, device="cpu")
    return model, lm_params_from_numpy(raw, model)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("name", ["llama3-8b", "llama-3.2-vision-90b"])
def test_engine_matches_reference(name, backend):
    raw, want = _reference(name)
    model, params = _port_model(name, raw)
    cfg = model.cfg
    t = QueueTransport()
    got = _scenario(lambda: ServeEngine(model, params, backend=backend, device="cpu", **ENGINE),
                    StreamPrimary(t, n_words=2, device="cpu"),
                    StreamReplica(t, backend=backend, device="cpu"), _prompts(cfg),
                    _extras(cfg))
    np.testing.assert_array_equal(got.pop("tokens"), want["tokens"])
    assert got.keys() == want.keys() - {"tokens"}
    for key in got:
        assert got[key] == want[key], key
    assert [got[f"restart_{r}"]["incremental"] for r in (1, 2, 3)] == [False, True, False]
    assert got["restart_3"]["fallback"] == "dbitmap_changed"
    assert all(got[f"standby_{r}"]["lag_frames"] == 0 for r in (1, 2, 3))
    assert sum(g is not None for g in got["gets_3"]) == len(got["table_3"])
    assert got["gets_3"] == got["standby_gets_3"]


def test_greedy_decode_matches_teacher_forcing():
    """Decode path == prefill path on the port: each greedy token is the
    argmax of a fresh prefill over its prefix."""
    model = LM(ARCHS["llama3-8b"].reduced(), compute_dtype=torch.float32, device="cpu")
    params = model.init(torch.Generator().manual_seed(1))
    prompts = _prompts(model.cfg, seed=1)
    eng = ServeEngine(model, params, max_seq=T + 4, batch_size=B, device="cpu")
    out = eng.generate(prompts, n_new=4)
    full = np.concatenate([prompts, out], axis=1)
    for i in range(4):
        _, logits = model.prefill(params, {"tokens": full[:, :T + i]},
                                  model.init_cache(B, T + 4))
        np.testing.assert_array_equal(logits.argmax(-1).numpy(), out[:, i])
    # admit starts from a fresh cache: the same prompts give the same tokens
    np.testing.assert_array_equal(eng.generate(prompts, n_new=4), out)


def test_sampled_tokens_follow_the_seed():
    model = LM(ARCHS["llama3-8b"].reduced(), compute_dtype=torch.float32, device="cpu")
    params = model.init(torch.Generator().manual_seed(2))
    eng = ServeEngine(model, params, device="cpu", **ENGINE)
    prompts = _prompts(model.cfg)
    a = eng.generate(prompts, 6, temperature=1.0, seed=3)
    b = eng.generate(prompts, 6, temperature=1.0, seed=3)
    c = eng.generate(prompts, 6, temperature=1.0, seed=4)
    assert a.shape == (B, 6) and a.dtype == np.int32
    assert ((a >= 0) & (a < model.cfg.vocab_size)).all()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    # a very low temperature is the greedy choice
    np.testing.assert_array_equal(eng.generate(prompts, 6, temperature=1e-6, seed=5),
                                  eng.generate(prompts, 6))


def test_admission_knobs_reach_the_pager():
    """The engine forwards its serving knobs to the pager, and the pager
    sheds and readmits as the reference engine's pager does."""
    cfg = ARCHS["llama3-8b"].reduced()
    model = LM(cfg, device="cpu")
    knobs = dict(read_through_dirty=True, max_lag_epochs=0, admission="shed")
    eng = ServeEngine(model, {}, device="cpu", **ENGINE, **knobs)
    ref = RefEngine(RefLM(REF_ARCHS[cfg.name].reduced(), remat=False), {}, **ENGINE, **knobs)
    for name, value in knobs.items():
        assert getattr(eng.pager, name) == getattr(ref.pager, name) == value
    assert eng.pager.n_pages == ref.pager.n_pages == 2 * B * 4
    assert eng.pager.backend == "cuda" and eng.pager.device.type == "cpu"
    shed = []
    for pm, exc in ((eng.pager, AdmissionShed), (ref.pager, RAdmissionShed)):
        pm.lag_entries_per_epoch = 4
        pm.pages_for(0, 64)
        pm.rebuild_index()
        pm.free_seq(0)
        pm.pages_for(1, 64)
        with pytest.raises(exc):
            pm.lookup(1, 0)
        pm.rebuild_index()
        shed.append((pm.lookup(1, 0), pm.stats["snapshot"]["shed"],
                     pm.stats["snapshot"]["lag_epochs"]))
    assert shed[0] == shed[1] and shed[0][1] == 1


def test_engine_checks_its_prompts():
    model = LM(ARCHS["llama3-8b"].reduced(), device="cpu")
    eng = ServeEngine(model, model.init(torch.Generator().manual_seed(0)), device="cpu",
                      **ENGINE)
    with pytest.raises(ValueError, match="do not fit"):
        eng.admit(np.zeros((B + 1, 4), np.int64))
    with pytest.raises(ValueError, match="do not fit"):
        eng.admit(np.zeros((B, ENGINE["max_seq"] + 1), np.int64))
    with pytest.raises(ValueError, match="StreamReplica"):
        eng.follow(StreamReplica(QueueTransport(), device="cpu"))
        eng.restart(backend="torch")


def test_launch_serve_main_reduced_on_cpu(capsys):
    from repro.launch.train import REPRO_100M as REF_100M

    assert dataclasses.asdict(launch_serve.REPRO_100M) == dataclasses.asdict(REF_100M)
    assert launch_serve.resolve_arch("llama3-8b", True) == ARCHS["llama3-8b"].reduced()
    res = launch_serve.main(["--arch", "llama3-8b", "--reduced", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "8", "--new-tokens", "4",
                             "--max-seq", "32"])
    assert res["tokens"].shape == (2, 4)
    assert res["restart"]["index_height"] >= 1 and res["restart"]["backend"] == "cuda"
    assert "generated (2, 4) tokens" in capsys.readouterr().out
