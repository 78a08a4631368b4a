"""Build, load and count the port's hand-written CUDA kernels.

The sources under ``repro_torch/csrc`` have a plain C interface (no
PyTorch headers), so each compiles in seconds.  At first use every ``.cu``
file is compiled by its own ``nvcc`` process, all started together, for
``sm_90a``; the objects are linked into one shared library named after a
hash of the sources and flags, under ``build/kernels`` at the repository
root, and loaded with ``ctypes``.  A library whose hash matches is reused.

``LAUNCHES`` counts the kernel launches of each wrapper: a wrapper adds
one exactly where it launches its kernel (never on its plain-PyTorch CPU
path), so a run can show which kernels its path went through.  A kernel
with more than one form also counts each form's launches in
``LAUNCHES_BY_FORM``.  A launch made while a CUDA graph is being
captured runs nothing: inside :func:`recording` it is recorded for the
graph instead of counted, and :func:`count_replay` adds the record to the
counts each time the graph replays.

Kernels launch from more than one thread (the multi-tenant engine's
dispatcher beside a writer's rebuild), so the first build and load of the
library and every count increment each run under a lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from contextlib import contextmanager
from pathlib import Path

import torch

__all__ = ["LAUNCHES", "LAUNCHES_BY_FORM", "reset_launches", "build", "lib", "launch",
           "check_tensor", "recording", "count_replay"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("pext.cu", "bitonic.cu", "pk_window.cu", "probe.cu", "merge_rank.cu", "dbit.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
#: C entry point -> argtypes (pointers and the stream as void*)
_SIGNATURES = {
    "repro_pext": (_P, _P, _P, _L, _I, _I, _I, _I, _P),
    "repro_bitonic_block_sort": (_P, _P, _P, _P, _L, _I, _I, _P),
    "repro_pk_window": (_P, _P, _P, _P, _L, _I, _I, _P),
    "repro_gather_window": (_P, _P, _P, _P, _P, _L, _I, _I, _P),
    "repro_probe": (_P, _P, _P, _P, _P, _I, _L, _I, _I, _L, _I, _P),
    "repro_probe_leaf": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _L, _L, _I, _P),
    "repro_merge_rank": (_P, _P, _P, _P, _P, _L, _L, _I, _P),
    "repro_dbit": (_P, _P, _L, _I, _P),
    "repro_dbitmap": (_P, _P, _L, _I, _P),
}

#: launches per kernel wrapper since the last :func:`reset_launches`
LAUNCHES = {"pext": 0, "bitonic_block_sort": 0, "pk_window": 0, "probe": 0,
            "merge_rank": 0, "dbit": 0, "probe_many": 0}
#: launches per form of the kernels that have more than one
LAUNCHES_BY_FORM = {"dbit": {"positions": 0, "bitmap": 0}}

_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()
#: this thread's launch record while it captures a graph
_capture = threading.local()
#: (seconds, compiler output) of the build this process did, if any
last_build: tuple[float, str] | None = None


def reset_launches() -> None:
    """Set every launch count to 0."""
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        for forms in LAUNCHES_BY_FORM.values():
            for form in forms:
                forms[form] = 0


@contextmanager
def recording():
    """Record, instead of count, the launches this thread makes inside the
    block (a graph capture): yields ``{"launches": {kernel: n}, "forms":
    {kernel: {form: n}}}``."""
    rec: dict = {"launches": {}, "forms": {}}
    prev = getattr(_capture, "rec", None)
    _capture.rec = rec
    try:
        yield rec
    finally:
        _capture.rec = prev


def count_replay(launches: dict, forms: dict) -> None:
    """Count the launches of one replay of a graph whose capture recorded
    ``launches`` and ``forms`` (see :func:`recording`)."""
    with _count_lock:
        for kernel, k in launches.items():
            LAUNCHES[kernel] += k
        for kernel, by_form in forms.items():
            for form, k in by_form.items():
                LAUNCHES_BY_FORM[kernel][form] += k


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build() -> Path:
    """Compile the kernels (one ``nvcc`` per source, in parallel) and link
    them into one shared library; returns its path.  Idempotent."""
    global last_build
    digest = hashlib.sha256()
    for name in sorted(p.name for p in CSRC.iterdir()):
        digest.update(name.encode() + (CSRC / name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    tag = digest.hexdigest()[:16]
    so = BUILD_DIR / f"librepro_kernels_{tag}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in SOURCES:
        obj = BUILD_DIR / f"{Path(src).stem}_{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    logs = []
    for src, proc in zip(SOURCES, procs):
        out, _ = proc.communicate()
        logs.append(f"== {src}\n{out}")
        if proc.returncode:
            for other in procs:
                other.wait()
            raise RuntimeError(f"nvcc failed on {src}:\n{out}")
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode:
        raise RuntimeError(f"linking the kernel library failed:\n{link.stdout}")
    os.replace(tmp, so)
    last_build = (time.perf_counter() - t0, "\n".join(logs))
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use, by one thread)."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                handle = ctypes.CDLL(str(build()))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(handle, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                _lib = handle
    return _lib


def check_tensor(name: str, t: torch.Tensor, device: torch.device, dtype,
                 ndim: int) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of rank ``ndim``
    on ``device`` (the kernels take raw pointers)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has rank {t.dim()}, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(kernel: str, entry: str, device: torch.device, *args,
           form: str | None = None) -> None:
    """Call C entry ``entry`` on ``device``'s current stream with ``args``
    (tensors pass their data pointer), raise on a CUDA error, and count
    one launch of ``kernel`` (and of its ``form``, if it has forms), or
    record it when this thread is capturing a graph."""
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(lib(), entry)(*c_args, stream)
    if err:
        raise RuntimeError(f"{kernel} kernel launch failed with CUDA error {err}")
    rec = getattr(_capture, "rec", None)
    if rec is not None:
        rec["launches"][kernel] = rec["launches"].get(kernel, 0) + 1
        if form is not None:
            forms = rec["forms"].setdefault(kernel, {})
            forms[form] = forms.get(form, 0) + 1
        return
    with _count_lock:
        LAUNCHES[kernel] += 1
        if form is not None:
            LAUNCHES_BY_FORM[kernel][form] += 1
