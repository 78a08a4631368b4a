"""The port's boundaries: what it imports, where it runs, and which path a
kernel wrapper takes.

* ``repro_torch`` and ``chip_smoke.py`` import neither JAX nor the
  reference package ``repro`` (checked in a fresh interpreter and by a scan
  of the sources);
* the entry points run on CUDA unless the caller names another device:
  with no GPU they raise instead of running on the host, and so does a
  lookup program of the plan cache built without naming the CPU;
* a CUDA kernel wrapper given a CPU tensor runs its plain version and
  launches nothing;
* the kernel library is built and loaded once, however many threads ask
  for it first;
* ``chip_smoke.py`` exits non-zero and prints no result without a GPU, and
  when it stands alone, away from the package.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.backends import get_backend  # noqa: E402
from repro_torch.backends.distributed import DistributedBackend  # noqa: E402
from repro_torch.ckpt import CheckpointIndex, restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.convert import tree_from_numpy  # noqa: E402
from repro_torch.core.btree import BTreeConfig, _as_stack, stack_trees  # noqa: E402
from repro_torch.core.compress import make_plan  # noqa: E402
from repro_torch.core.dbits import compute_dbitmap  # noqa: E402
from repro_torch.core.index import OnlineIndex  # noqa: E402
from repro_torch.core.keyformat import KeySet  # noqa: E402
from repro_torch.core.metadata import meta_from_keys  # noqa: E402
from repro_torch.core.plancache import PlanCache  # noqa: E402
from repro_torch.core.pipeline import ReconstructionPipeline  # noqa: E402
from repro_torch.core.reconstruct import full_key_reconstruct, reconstruct_index  # noqa: E402
from repro_torch.core.u32 import to_carrier, to_u32  # noqa: E402
from repro_torch.kernels import cudalib  # noqa: E402
from repro_torch.kernels.bitonic import block_sort, block_sort_plain  # noqa: E402
from repro_torch.kernels.build import pk_windows, pk_windows_plain  # noqa: E402
from repro_torch.kernels.dbit import adjacent_dbits, adjacent_dbits_plain  # noqa: E402
from repro_torch.kernels.lookup import (  # noqa: E402
    leaf_stage,
    leaf_stage_many,
    leaf_stage_many_plain,
    probe,
    probe_many,
    probe_many_plain,
    probe_plain,
)
from repro_torch.kernels.lookup.ref import leaf_arena, member_tree  # noqa: E402
from repro_torch.kernels.merge import merge_ranks, merge_ranks_plain, merge_sorted  # noqa: E402
from repro_torch.kernels.pext import pext, pext_plain  # noqa: E402
from repro_torch.replication import (  # noqa: E402
    QueueTransport,
    Replica,
    StreamPrimary,
    StreamReplica,
)
from repro_torch.serve import MultiTenantEngine, TenantRegistry  # noqa: E402
from repro_torch.serve.loadgen import run_load, run_multitenant_load, run_pager_load  # noqa: E402
from repro_torch.serve.pager import PagedKVManager  # noqa: E402
from repro_torch.tools import chaos_soak  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.convert import lm_cache_from_numpy  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.core.sortkeys import compressed_key_sort  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline, dedup_tokens, shuffle_order  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "src" / "repro_torch"
#: the examples' twins on the port
TWINS = [ROOT / "examples" / f"{name}_torch.py"
         for name in ("quickstart", "train_lm", "serve_moe", "replication")]
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:[.\s,]|$)", re.M)


def _keyset(n=300, w=3, seed=0) -> KeySet:
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, size=(n, w), dtype=np.uint32) & np.uint32(0x00FF0F0F)
    return KeySet(words=words, lengths=np.full(n, 4 * w, np.int32),
                  rids=np.arange(n, dtype=np.uint32))


# ---------------------------------------------------------------------------
# imports
# ---------------------------------------------------------------------------


def test_package_and_smoke_script_import_neither_jax_nor_reference():
    """A fresh interpreter imports every module of the port and loads
    the example twins and ``chip_smoke.py`` as modules (``main`` not run);
    neither JAX nor the reference package may be loaded after it."""
    code = f"""
import importlib, importlib.util, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
for path in {[str(p) for p in TWINS] + [str(ROOT / "chip_smoke.py")]!r}:
    spec = importlib.util.spec_from_file_location("loaded", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps([names, bad]))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", "import json\n" + code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    names, bad = json.loads(out.stdout.splitlines()[-1])
    assert len(names) >= 20
    for name in ("repro_torch.kernels.merge.ops", "repro_torch.kernels.merge.ref",
                 "repro_torch.kernels.dbit.ops", "repro_torch.kernels.dbit.ref",
                 "repro_torch.core.snapshot", "repro_torch.serve",
                 "repro_torch.serve.tenants", "repro_torch.serve.loadgen",
                 "repro_torch.serve.pager",
                 "repro_torch.core.index", "repro_torch.replication.log",
                 "repro_torch.replication.wire", "repro_torch.replication.transport",
                 "repro_torch.replication.replica", "repro_torch.replication.stream",
                 "repro_torch.replication.supervisor", "repro_torch.replication.chaos",
                 "repro_torch.ckpt", "repro_torch.ckpt.checkpoint",
                 "repro_torch.tools.chaos_soak", "repro_torch.core.distsort",
                 "repro_torch.backends.distributed", "repro_torch.tools.rankgroup",
                 "repro_torch.configs", "repro_torch.configs.base",
                 "repro_torch.configs.llama3_8b", "repro_torch.configs.paper_index",
                 "repro_torch.models", "repro_torch.models.layers", "repro_torch.models.moe",
                 "repro_torch.models.ssm", "repro_torch.models.xlstm", "repro_torch.models.lm",
                 "repro_torch.serve.engine", "repro_torch.launch", "repro_torch.launch.serve",
                 "repro_torch.launch.train", "repro_torch.train", "repro_torch.train.optim",
                 "repro_torch.train.trainstep", "repro_torch.train.compression",
                 "repro_torch.data.pipeline", "repro_torch.data.synthetic",
                 "repro_torch.distributed", "repro_torch.distributed.sharding",
                 "repro_torch.distributed.ctx", "repro_torch.launch.mesh",
                 "repro_torch.launch.shardings", "repro_torch.launch.opcount",
                 "repro_torch.launch.dryrun", "repro_torch.launch.roofline"):
        assert name in names
    assert bad == []


def test_sources_name_neither_jax_nor_reference():
    files = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"] + TWINS
    assert len(files) > 20
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if FORBIDDEN.search(f.read_text())]
    assert offenders == []


def test_serving_modules_name_neither_jax_nor_reference_anywhere():
    """The pager and the load harnesses name neither JAX's module nor the
    reference package as code, not even in a docstring or comment."""
    mention = re.compile(r"\b(?:import|from)\s+(?:jax|jaxlib|repro)\b(?!_)"
                         r"|\bjax\.|(?<![\w.])repro\.")
    for name in ("pager.py", "loadgen.py", "__init__.py"):
        text = (PACKAGE / "serve" / name).read_text()
        assert not mention.search(text), name
    assert mention.search("see repro.serve.pager") and mention.search("x = jax.numpy")
    assert not mention.search("see repro_torch.serve.pager")


def test_plan_cache_and_its_programs_name_neither_jax_nor_reference_anywhere():
    """The plan cache and the modules whose bodies it caches name neither
    JAX's module nor the reference package, not even in a docstring."""
    mention = re.compile(r"\b(?:import|from)\s+(?:jax|jaxlib|repro)\b(?!_)"
                         r"|\bjax\.|(?<![\w.])repro\.")
    for name in ("core/plancache.py", "core/btree.py", "core/pipeline.py", "backends/base.py",
                 "backends/cuda_backend.py", "backends/torch_backend.py",
                 "kernels/cudalib.py", "tools/chaos_soak.py"):
        assert not mention.search((PACKAGE / name).read_text()), name


def test_distributed_modules_name_neither_jax_nor_reference_anywhere():
    """The distributed backend, the sample sort and the rank launcher name
    neither JAX's module nor the reference package, not even in a
    docstring."""
    mention = re.compile(r"\b(?:import|from)\s+(?:jax|jaxlib|repro)\b(?!_)"
                         r"|\bjax\.|(?<![\w.])repro\.")
    for name in ("core/distsort.py", "backends/distributed.py", "tools/rankgroup.py",
                 "core/__init__.py", "backends/__init__.py"):
        assert not mention.search((PACKAGE / name).read_text()), name


def test_lm_modules_name_neither_jax_nor_reference_anywhere():
    """The configs, the models, the engine, the training path (optimizer,
    train step, compression, token pipeline), the mesh layer and the
    launchers name neither JAX's module nor the reference package, not
    even in a docstring."""
    mention = re.compile(r"\b(?:import|from)\s+(?:jax|jaxlib|repro)\b(?!_)"
                         r"|\bjax\.|(?<![\w.])repro\.")
    files = (sorted((PACKAGE / "configs").glob("*.py")) + sorted((PACKAGE / "models").glob("*.py"))
             + sorted((PACKAGE / "launch").glob("*.py")) + sorted((PACKAGE / "train").glob("*.py"))
             + sorted((PACKAGE / "data").glob("*.py"))
             + sorted((PACKAGE / "distributed").glob("*.py"))
             + [PACKAGE / "serve" / "engine.py", PACKAGE / "convert.py",
                PACKAGE / "core" / "sortkeys.py", PACKAGE / "ckpt" / "checkpoint.py"])
    assert len(files) >= 36
    for path in files:
        assert not mention.search(path.read_text()), path.name


def test_example_twins_name_neither_jax_nor_reference_anywhere():
    """The examples' twins name neither JAX's module nor the reference
    package, not even in a docstring."""
    mention = re.compile(r"\b(?:import|from)\s+(?:jax|jaxlib|repro)\b(?!_)"
                         r"|\bjax\.|(?<![\w.])repro\.")
    assert sorted(p.name for p in (ROOT / "examples").glob("*_torch.py")) == sorted(
        p.name for p in TWINS)
    for path in TWINS:
        assert not mention.search(path.read_text()), path.name


def _twin(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_no_device_wide_synchronize_outside_the_stream_wait():
    """The port waits for the card only through ``u32.sync_stream``, a wait
    for the calling thread's own stream.  A device-wide synchronize (or
    ``torch.cuda.graph``'s entry, which makes one) in any thread waits on
    the stream another thread is capturing a lookup graph on, and that
    invalidates the capture; so no source of ``core/``, ``ckpt/`` or
    ``serve/`` (nor any other module of the package) makes one."""
    import inspect

    from repro_torch.core import plancache, u32

    wide = re.compile(r"\bcuda\.synchronize\(|\bcuda\.graph\(|cudaDeviceSynchronize"
                      r"|\.synchronize\(\)")
    guarded = [f for sub in ("core", "ckpt", "serve") for f in sorted((PACKAGE / sub).rglob("*.py"))]
    assert len(guarded) > 15
    files = sorted(set(guarded) | set(PACKAGE.rglob("*.py")) | set(PACKAGE.rglob("*.cu")))
    helper = inspect.getsource(u32.sync_stream)
    offenders = []
    for f in files:
        text = f.read_text()
        if f == PACKAGE / "core" / "u32.py":
            text = text.replace(helper, "")
        offenders += [f"{f.relative_to(ROOT)}: {m.group(0)}" for m in wide.finditer(text)]
    assert offenders == []
    # the one release of the allocator's cache (a device-wide call) runs
    # under the capture lock that every capture holds
    frees = [(f, line) for f in files for line in f.read_text().splitlines()
             if "empty_cache(" in line and not line.lstrip().startswith("#")]
    assert [f.relative_to(PACKAGE).as_posix() for f, _ in frees] == ["core/plancache.py"]
    capture = inspect.getsource(plancache._Graphed._capture)
    assert "with _CAPTURE_LOCK:\n            torch.cuda.empty_cache()" in capture
    assert capture.index("with _CAPTURE_LOCK:") < capture.index("graph.capture_begin(")
    # the helper itself waits for one stream, never the device
    assert "current_stream(device).synchronize()" in helper
    assert not re.search(r"\bcuda\.synchronize\(", helper)
    assert wide.search("torch.cuda.synchronize(dev)") and wide.search("with torch.cuda.graph(g):")
    u32.sync_stream("cpu")  # a no-op off CUDA


def test_rank_group_starts_its_ranks_with_spawn(monkeypatch):
    """The ranks start with ``spawn``, never ``fork``: the parent may hold
    a CUDA context, which a forked child cannot use."""
    from repro_torch.tools import rankgroup

    asked = []

    class Stop(Exception):
        pass

    def get_context(method=None):
        asked.append(method)
        raise Stop

    monkeypatch.setattr(rankgroup.mp, "get_context", get_context)
    with pytest.raises(Stop):
        rankgroup.run_group(print, 2)
    assert asked == ["spawn"]
    assert '"fork"' not in (PACKAGE / "tools" / "rankgroup.py").read_text()


def test_lookup_program_without_gpu_runs_only_where_the_cpu_is_named(no_gpu):
    from repro_torch.core import plancache

    cache = plancache.PlanCache()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cache.graphed(lambda tree, q, n: (q, n))
    prog = cache.graphed(lambda tree, q, n: (q[:1] + n, n), device="cpu")
    out, nv = prog(None, torch.zeros((4, 2), dtype=torch.int64), 3)
    assert out.tolist() == [[3, 3]] and nv.item() == 3 and not prog.captured
    assert cache.stats()["traces"] == 1


def test_forbidden_import_pattern():
    """The scan's pattern catches the reference and JAX, not the port."""
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("from repro.core import dbits")
    assert FORBIDDEN.search("    import repro")
    assert not FORBIDDEN.search("from repro_torch.core import dbits")
    assert not FORBIDDEN.search("import repro_torch")


# ---------------------------------------------------------------------------
# the device rule: CUDA unless the caller names another device
# ---------------------------------------------------------------------------


@pytest.fixture
def no_gpu(monkeypatch):
    """A machine without a GPU, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", [
    "pipeline_cuda", "pipeline_torch", "backend_cuda", "backend_torch",
    "reconstruct_index", "full_key_reconstruct", "meta_from_keys", "tree_from_numpy",
    "run_multitenant_load", "multitenant_engine", "online_index_build", "online_index",
    "run_many", "replica", "stream_primary", "stream_primary_untracked", "stream_replica",
    "save_checkpoint", "checkpoint_index", "restore_checkpoint", "run_soak", "chaos_soak_cli",
    "paged_kv_manager", "run_load", "run_pager_load", "lookup_program",
    "backend_distributed", "distributed_backend", "pipeline_distributed",
    "lm", "serve_engine", "launch_serve", "lm_cache_from_numpy",
    "launch_train", "shuffle_order", "dedup_tokens", "token_pipeline", "compressed_key_sort",
    "train_lm_twin", "serve_moe_twin", "replication_twin",
])
def test_default_device_entry_points_raise_without_gpu(no_gpu, entry, tmp_path):
    ks = _keyset()
    tree = {"w": np.arange(6, dtype=np.float32)}
    save_checkpoint(tmp_path / "ckpt", 1, tree, device="cpu")
    step_dir = tmp_path / "ckpt" / "step_00000001"
    calls = {
        "pipeline_cuda": lambda: ReconstructionPipeline(),
        "pipeline_torch": lambda: ReconstructionPipeline(backend="torch"),
        "backend_cuda": lambda: get_backend("cuda"),
        "backend_torch": lambda: get_backend("torch"),
        "reconstruct_index": lambda: reconstruct_index(ks),
        "full_key_reconstruct": lambda: full_key_reconstruct(ks),
        "meta_from_keys": lambda: meta_from_keys(ks.words),
        "tree_from_numpy": lambda: tree_from_numpy(
            [], {"rid": np.zeros((1, 12), np.uint32)}, ks.words[:1], ks.rids[:1], 1,
            BTreeConfig()),
        "run_multitenant_load": lambda: run_multitenant_load(n_tenants=1, n_keys=64,
                                                             duration_s=0.0),
        "multitenant_engine": lambda: MultiTenantEngine(TenantRegistry(), get_backend("cuda"),
                                                        auto_dispatch=False),
        "online_index_build": lambda: OnlineIndex.build(ks),
        "online_index": lambda: OnlineIndex(ks, reconstruct_index(ks, device="cpu")),
        "run_many": lambda: ReconstructionPipeline().run_many([ks, ks]),
        "replica": lambda: Replica(ks),
        "stream_primary": lambda: StreamPrimary(QueueTransport(), ks),
        "stream_primary_untracked": lambda: StreamPrimary(QueueTransport(), n_words=3),
        "stream_replica": lambda: StreamReplica(QueueTransport()),
        "save_checkpoint": lambda: save_checkpoint(tmp_path / "ckpt", 2, tree),
        "checkpoint_index": lambda: CheckpointIndex(step_dir),
        "restore_checkpoint": lambda: restore_checkpoint(tmp_path / "ckpt", 1, tree),
        "run_soak": lambda: chaos_soak.run_soak(0, "queue", "torch", str(tmp_path),
                                                steps=2, n_replicas=1),
        "chaos_soak_cli": lambda: chaos_soak.main(["--seeds", "0", "--transports", "queue",
                                                   "--fast", "--backend", "torch"]),
        "paged_kv_manager": lambda: PagedKVManager(n_pages=8, page_tokens=4, backend="torch"),
        "run_load": lambda: run_load(n_keys=64, duration_s=0.0),
        "run_pager_load": lambda: run_pager_load(n_pages=8, n_seqs=1, pages_per_seq=1,
                                                 duration_s=0.0),
        "lookup_program": lambda: PlanCache().graphed(lambda tree, q, n: q),
        "backend_distributed": lambda: get_backend("distributed"),
        "distributed_backend": lambda: DistributedBackend(),
        "pipeline_distributed": lambda: ReconstructionPipeline(
            backend="distributed", backend_opts={"capacity_factor": 2.0}),
        "lm": lambda: LM(ARCHS["llama3-8b"].reduced()),
        "serve_engine": lambda: ServeEngine(LM(ARCHS["llama3-8b"].reduced(), device="cpu"), {},
                                            max_seq=32, batch_size=2),
        "launch_serve": lambda: launch_serve.main(["--arch", "llama3-8b", "--reduced"]),
        "lm_cache_from_numpy": lambda: lm_cache_from_numpy({"0": {"k": np.zeros(2)}}),
        "launch_train": lambda: launch_train.main(["--arch", "llama3-8b", "--reduced",
                                                   "--ckpt-dir", str(tmp_path / "train")]),
        "shuffle_order": lambda: shuffle_order(100, 0),
        "dedup_tokens": lambda: dedup_tokens(np.zeros((4, 3), np.int32)),
        "token_pipeline": lambda: TokenPipeline(np.zeros((8, 5), np.int32), 2, 4),
        "compressed_key_sort": lambda: compressed_key_sort(ks.words, ks.rids,
                                                           make_plan(np.ones(3, np.uint32), 3)),
        "train_lm_twin": lambda: _twin("train_lm_torch").main(
            ["--quick", "--ckpt-dir", str(tmp_path / "twin")]),
        "serve_moe_twin": lambda: _twin("serve_moe_torch").main([]),
        "replication_twin": lambda: _twin("replication_torch").main(["--fast"]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    # a refused save leaves no step behind, not even a temporary one
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["step_00000001"]


def test_serving_entry_points_default_to_cuda():
    import dataclasses
    import inspect

    for fn in (run_load, run_pager_load, run_multitenant_load):
        params = inspect.signature(fn).parameters
        assert params["backend"].default == "cuda" and params["device"].default is None
    fields = {f.name: f.default for f in dataclasses.fields(PagedKVManager)}
    assert fields["backend"] == "cuda" and fields["device"] is None
    for cls in (ServeEngine, LM):
        fields = {f.name: f.default for f in dataclasses.fields(cls)}
        assert fields["device"] is None and fields.get("backend", "cuda") == "cuda"


def test_explicit_cpu_device_runs_on_the_host(no_gpu):
    res = reconstruct_index(_keyset(), device="cpu")
    assert res.comp_sorted.device.type == "cpu"
    assert res.stats["device"] == "cpu"
    model = LM(ARCHS["llama3-8b"].reduced(), device="cpu")
    eng = ServeEngine(model, model.init(torch.Generator().manual_seed(0)), max_seq=32,
                      batch_size=2, device="cpu")
    assert eng.generate(np.zeros((2, 4), np.int64), 2).shape == (2, 2)
    assert eng.pager.device.type == "cpu" and eng._cache["0"]["k"].device.type == "cpu"


def test_smoke_script_refuses_to_run_without_gpu(no_gpu, capsys):
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_smoke_script_fails_alone(tmp_path):
    """Copied into a directory that holds nothing else of the repository,
    the script exits non-zero and prints no result line."""
    (tmp_path / "chip_smoke.py").write_bytes((ROOT / "chip_smoke.py").read_bytes())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        assert not (line.startswith("{") and json.loads(line).get("ok"))


# ---------------------------------------------------------------------------
# a CUDA kernel wrapper on a CPU tensor: the plain version, no launch
# ---------------------------------------------------------------------------


@pytest.fixture
def no_kernel_library(monkeypatch):
    """Any attempt to build or load the kernel library fails the test."""
    def refuse():
        raise AssertionError("a CPU tensor reached the CUDA kernel library")

    monkeypatch.setattr(cudalib, "lib", refuse)
    cudalib.reset_launches()
    yield
    assert all(count == 0 for count in cudalib.LAUNCHES.values()), cudalib.LAUNCHES


def test_pext_wrapper_on_cpu_takes_plain_version(no_kernel_library):
    words = to_carrier(_keyset(n=257, w=4).words, "cpu")
    plan = make_plan(to_u32(compute_dbitmap(words)), 4)
    assert torch.equal(pext(words, plan), pext_plain(words, plan))


def test_block_sort_wrapper_on_cpu_takes_plain_version(no_kernel_library):
    words = to_carrier(_keyset(n=300, w=2).words, "cpu")
    rows = torch.randperm(300, generator=torch.Generator().manual_seed(0))
    got, want = block_sort(words, rows, block=64), block_sort_plain(words, rows, block=64)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_pk_window_and_probe_wrappers_on_cpu_take_plain_versions(no_kernel_library):
    words = to_carrier(_keyset(n=96, w=3).words, "cpu")
    starts = torch.arange(96) - 1  # clipped, word boundaries, last word
    assert torch.equal(pk_windows(words, starts, 16), pk_windows_plain(words, starts, 16))
    node = torch.arange(8) % 4
    dpos = starts.reshape(8, 12)[:4]
    leaf_pk = pk_windows_plain(words[:48], starts[:48] + 1, 16).reshape(4, 12)
    assert torch.equal(probe(words[:8], node, dpos, leaf_pk, 16),
                       probe_plain(words[:8], node, dpos, leaf_pk, 16))


def test_probe_many_wrapper_on_cpu_takes_plain_version(no_kernel_library):
    words = to_carrier(_keyset(n=96, w=3).words, "cpu")
    starts = (torch.arange(96) - 1).reshape(2, 4, 12)  # clipped, boundaries, last word
    leaf_pk = pk_windows_plain(words[:48].repeat(2, 1), starts.reshape(-1) + 1, 16)
    queries = words[:16].reshape(2, 8, 3)
    node = (torch.arange(16) % 4).reshape(2, 8)
    got = probe_many(queries, node, starts, leaf_pk.reshape(2, 4, 12), 16)
    assert torch.equal(got, probe_many_plain(queries, node, starts,
                                             leaf_pk.reshape(2, 4, 12), 16))


def test_leaf_stage_wrappers_on_cpu_take_plain_versions(no_kernel_library):
    arena, queries, node = leaf_arena(0, 2, 3, 6, 12, 3, 16, 40, "cpu")
    got, want = leaf_stage_many(arena, node, queries), leaf_stage_many_plain(arena, node, queries)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(got[0].any()) and not bool(got[0].all())
    member = member_tree(arena, 0)
    got = leaf_stage(_as_stack(member), node[:1], queries[:1])
    want = leaf_stage_many_plain(_as_stack(member), node[:1], queries[:1])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_merge_rank_and_dbit_wrappers_on_cpu_take_plain_versions(no_kernel_library):
    words = torch.sort(to_carrier(_keyset(n=200, w=1).words, "cpu"), dim=0).values
    rows = torch.arange(200)
    keys_a, keys_b = words[::2].contiguous(), words[1::2].contiguous()
    assert torch.equal(merge_ranks(keys_b, rows[1::2], keys_a, rows[::2]),
                       merge_ranks_plain(keys_b, rows[1::2], keys_a, rows[::2]))
    merged, merged_rows = merge_sorted(keys_a, rows[::2], keys_b, rows[1::2])
    assert torch.equal(merged, words) and torch.equal(merged_rows, rows)
    assert torch.equal(adjacent_dbits(words), adjacent_dbits_plain(words))


def test_cuda_backend_on_cpu_launches_nothing(no_kernel_library):
    ks = _keyset(n=500, w=3, seed=1)
    res = ReconstructionPipeline(backend="cuda", device="cpu", chunk_threshold=256,
                                 chunk_size=128).run(ks)
    assert res.stats["chunked"] == 4
    res, folded = ReconstructionPipeline(backend="cuda", device="cpu").run_incremental(
        res, ks, keep_rows=np.arange(500) % 3 > 0)
    assert res.stats["incremental"] is True
    found, rid = get_backend("cuda", device="cpu").lookup(
        res.tree, to_carrier(folded.words[:64], "cpu"))
    assert bool(found.all())
    np.testing.assert_array_equal(to_u32(rid), folded.rids[:64])
    found, rid = get_backend("cuda", device="cpu").lookup_many(
        stack_trees([res.tree, res.tree]), to_carrier(folded.words[:64], "cpu")[None], [60])
    assert bool(found[0, :60].all())
    np.testing.assert_array_equal(to_u32(rid)[0, :60], folded.rids[:60])


# ---------------------------------------------------------------------------
# the kernel library under threads
# ---------------------------------------------------------------------------


def test_kernel_library_builds_and_loads_once_across_threads(monkeypatch):
    """Eight threads ask for the library at once: one build, one load, and
    every thread gets the same handle."""
    builds, loads = [], []

    def slow_build():
        builds.append(threading.get_ident())
        time.sleep(0.05)  # a window for the other threads to race into
        return Path("librepro_kernels_stub.so")

    class FakeLibrary:
        def __init__(self, path):
            loads.append(path)

        def __getattr__(self, name):
            fn = lambda *args: 0  # noqa: E731
            self.__dict__[name] = fn
            return fn

    monkeypatch.setattr(cudalib, "_lib", None)
    monkeypatch.setattr(cudalib, "build", slow_build)
    monkeypatch.setattr(cudalib.ctypes, "CDLL", FakeLibrary)
    barrier = threading.Barrier(8)
    got = []

    def ask():
        barrier.wait()
        got.append(cudalib.lib())

    threads = [threading.Thread(target=ask) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert len(builds) == 1 and len(loads) == 1 and len(got) == 8
    assert all(handle is got[0] for handle in got)
