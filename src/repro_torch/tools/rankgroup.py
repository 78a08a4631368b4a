"""Start a group of ranks on one host: the port's counterpart of the
reference's ``--xla_force_host_platform_device_count``.

``run_group(fn, p, *args)`` starts ``p`` processes with ``spawn`` (never
``fork``: the caller may already hold a CUDA context), joins them into
one gloo process group over a ``file://`` rendezvous in a
fresh temporary directory, runs ``fn(rank, p, *args)`` on every rank and
returns the ranks' return values in rank order.

* ``fn`` and ``args`` cross by pickle: ``fn`` must be a module-level
  function of an importable module (the spawned interpreter imports it;
  a script's functions come from its ``__main__``, whose phases stay
  behind its ``if __name__ == "__main__"`` guard).
* The group is gloo's: it carries CPU tensors, and CUDA tensors through
  host copies, so several ranks can share one GPU (NCCL takes one rank
  per GPU).  ``GLOO_SOCKET_IFNAME`` is set to the loopback device when
  unset, since the ranks talk on one host.
* A rank with a GPU uses device ``rank % device_count`` as its current
  CUDA device.
* ``init_process_group`` gets ``timeout``, which also bounds every
  collective: a rank stuck in one fails within it.  The whole group is
  bounded by ``deadline``.
* A rank that raises sends its traceback; the parent then stops the other
  ranks and raises :class:`RankError` with it.  A rank that dies without
  one (killed, out of memory) raises with its exit code.

``run_threads(fn, p, *args)`` runs the ranks as ``p`` threads of this
process instead, joined into one group of PyTorch's threaded test backend
(``torch.testing._internal.distributed.multi_threaded_pg``): its
collectives are tensor ops on the ranks' own devices, with no transport.
It is for what gloo cannot carry: gloo runs ``torch.distributed``'s
collectives on CUDA tensors, but a functional collective's wait (the
form DTensor issues) faulted on them with PyTorch 2.11.  The ranks share
one interpreter, so their host work is serial, and one CUDA allocator, so
the card's peak is theirs together.

Usage::

    from repro_torch.tools.rankgroup import run_group

    def work(rank, p, n):          # in an importable module
        ...
        return result

    results = run_group(work, 4, 1024)
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path

__all__ = ["RankError", "run_group", "run_threads"]


class RankError(RuntimeError):
    """A rank of a group failed, hung past the deadline, or died."""


def _rank_main(fn, rank: int, p: int, args: tuple, init_method: str, timeout_s: float,
               out_path: str) -> None:
    """One rank: join the group, run ``fn``, write ``("ok", value, t)`` or
    ``("error", traceback, t)`` to ``out_path``, ``t`` the wall clock when
    ``fn`` returned or raised (before the group is torn down, which is
    what the other ranks see fail next)."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    status = None
    try:
        import torch
        import torch.distributed as dist

        if torch.cuda.is_available():
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group("gloo", init_method=init_method, world_size=p, rank=rank,
                                timeout=timedelta(seconds=timeout_s))
        try:
            status = ("ok", fn(rank, p, *args), time.time())
        except BaseException:  # the parent re-raises it with this traceback
            status = ("error", traceback.format_exc(), time.time())
        finally:
            dist.destroy_process_group()
    except BaseException:
        if status is None or status[0] == "ok":
            status = ("error", traceback.format_exc(), time.time())
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(status, f)
    os.replace(tmp, out_path)
    if status[0] != "ok":
        os._exit(1)


def _first_failure(procs, outs) -> str:
    """The failure that came first: a rank that raised, by the time it
    wrote its traceback (the ranks it left waiting in a collective fail
    after it), else a rank that died without one."""
    errors = []
    for r, path in enumerate(outs):
        if os.path.exists(path):
            with open(path, "rb") as f:
                kind, detail, at = pickle.load(f)
            if kind != "ok":
                errors.append((at, r, detail))
    if errors:
        _, r, detail = min(errors)
        return f"rank {r} of {len(outs)} failed:\n{detail}"
    dead = [(r, proc.exitcode) for r, proc in enumerate(procs) if proc.exitcode not in (None, 0)]
    return f"rank {dead[0][0]} of {len(outs)} died with exit code {dead[0][1]}, no traceback"


def _stop(procs) -> None:
    for proc in procs:
        if proc.is_alive():
            proc.terminate()
    for proc in procs:
        proc.join(10)
        if proc.is_alive():
            proc.kill()
            proc.join()


def run_group(fn, p: int, *args, timeout: float = 60.0, deadline: float = 600.0) -> list:
    """Run ``fn(rank, p, *args)`` on ``p`` spawned ranks of one process
    group; their return values in rank order.

    ``timeout`` bounds the rendezvous and each collective (seconds);
    ``deadline`` the whole group.  Raises :class:`RankError` with the
    failing rank's traceback if any rank fails, and stops the others.
    """
    if p < 1:
        raise ValueError(f"a group needs at least one rank, got {p}")
    ctx = mp.get_context("spawn")
    tmp = Path(tempfile.mkdtemp(prefix="rankgroup-"))
    init_method = f"file://{tmp / 'rendezvous'}"
    outs = [str(tmp / f"rank{r}.pkl") for r in range(p)]
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(fn, r, p, args, init_method, float(timeout), outs[r]))
             for r in range(p)]
    try:
        for proc in procs:
            proc.start()
        end = time.monotonic() + float(deadline)
        while True:
            codes = [proc.exitcode for proc in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed or all(c == 0 for c in codes):
                break
            if time.monotonic() > end:
                _stop(procs)
                raise RankError(f"the group of {p} ranks passed its {deadline:.0f} s deadline; "
                                f"ranks still running: "
                                f"{[r for r, c in enumerate(codes) if c is None]}")
            time.sleep(0.05)
        if failed:
            _stop(procs)
            raise RankError(_first_failure(procs, outs))
        results = []
        for r in range(p):
            with open(outs[r], "rb") as f:
                kind, value, _ = pickle.load(f)
            if kind != "ok":
                raise RankError(f"rank {r} of {p} failed:\n{value}")
            results.append(value)
        return results
    finally:
        _stop(procs)
        shutil.rmtree(tmp, ignore_errors=True)


def run_threads(fn, p: int, *args, timeout: float = 600.0) -> list:
    """Run ``fn(rank, p, *args)`` on ``p`` threads joined into one group of
    the threaded backend; their return values in rank order.

    A rank's CUDA device is ``rank % device_count``.  ``timeout`` bounds
    the whole group; a rank that raises wakes the others (their
    collectives raise too) and :class:`RankError` carries its traceback.
    """
    import threading

    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed import multi_threaded_pg as mtpg

    if p < 1:
        raise ValueError(f"a group needs at least one rank, got {p}")
    if dist.is_initialized():
        raise RankError("run_threads needs a process without a process group")
    results, errors = [None] * p, [None] * p
    store = dist.HashStore()

    def rank_main(rank: int) -> None:
        try:
            if torch.cuda.is_available():
                torch.cuda.set_device(rank % torch.cuda.device_count())
            dist.init_process_group("threaded", rank=rank, world_size=p, store=store)
            try:
                results[rank] = fn(rank, p, *args)
            finally:
                # PyTorch 2.11's destroy reads a field its own threaded world
                # lacks; there, uninstalling the world below drops the groups
                if hasattr(dist.distributed_c10d._world, "comms"):
                    dist.destroy_process_group()
        except BaseException as ex:
            errors[rank] = (time.time(), traceback.format_exc())
            mtpg.ProcessLocalGroup.exception_handle(ex)  # wake the waiting ranks

    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    mtpg._install_threaded_pg()
    try:
        threads = [threading.Thread(target=rank_main, args=(r,), name=f"rank{r}", daemon=True)
                   for r in range(p)]
        for t in threads:
            t.start()
        end = time.monotonic() + float(timeout)
        for t in threads:
            t.join(max(end - time.monotonic(), 0.0))
        if any(t.is_alive() for t in threads):
            raise RankError(f"the {p} threaded ranks passed their {timeout:.0f} s timeout")
        failed = [(e[0], r, e[1]) for r, e in enumerate(errors) if e is not None]
        if failed:
            _, r, detail = min(failed)
            raise RankError(f"rank {r} of {p} failed:\n{detail}")
        return results
    finally:
        mtpg._uninstall_threaded_pg()
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
