"""Build the port's CUDA sources into shared libraries, loaded with ctypes.

Each ``csrc/*.cu`` file has a plain ``extern "C"`` interface. It is
compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -I kernels/csrc

into ``build/kernels/`` at the root of the checkout (``.gitignore`` lists
it; ``REPRO_TORCH_BUILD_DIR`` overrides it). Headers shared by several
kernels (the Half-Gate cipher) live in ``kernels/csrc/``. The library's
file name carries a digest of the flags, the source and every file it
``#include "..."``s, followed transitively, so a source whose header was
edited is rebuilt and a finished build is reused by every later
process. ``nvcc`` writes to a temporary name and the result is renamed
into place, so processes that build at the same time do not see
half-written files. ``ptxas`` register and spill counts are kept beside
the library as ``<name>.log``.

Building needs ``nvcc`` (``$CUDA_HOME/bin`` or ``/usr/local/cuda/bin``);
there is no fallback when it is missing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List

#: headers shared by the kernels of several packages
INCLUDE_DIR = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)


@dataclass
class Built:
    """One compiled library: where it is, how long ``nvcc`` took (0 when
    an earlier build was reused) and what ``ptxas`` reported."""

    source: Path
    path: Path
    seconds: float
    log: str


_lock = threading.Lock()
_loaded: Dict[Path, ctypes.CDLL] = {}
_built: Dict[Path, Built] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def dependencies(source: Path) -> List[Path]:
    """``source`` and every file it ``#include "..."``s, transitively;
    a name resolves against the including file's folder, then
    :data:`INCLUDE_DIR`, as ``nvcc`` resolves it."""
    seen: Dict[Path, None] = {}
    todo = [Path(source).resolve()]
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen[f] = None
        for name in _INCLUDE.findall(f.read_text()):
            for d in (f.parent, INCLUDE_DIR):
                if (d / name).is_file():
                    todo.append((d / name).resolve())
                    break
            else:
                raise FileNotFoundError(f"{f}: included {name!r} not found")
    return list(seen)


def _target(source: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in dependencies(source):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return build_dir() / f"{source.stem}-{h.hexdigest()[:16]}.so"


def _start(source: Path):
    out = _target(source)
    if out.exists():
        return out, None, 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o", str(tmp),
           str(source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp, cmd), time.perf_counter()


def _finish(source: Path, out: Path, job, t0: float) -> Built:
    if job is None:
        log_path = out.with_suffix(".log")
        log = log_path.read_text() if log_path.exists() else ""
        return Built(source, out, 0.0, log)
    proc, tmp, cmd = job
    log, _ = proc.communicate()
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {source}:\n"
                           f"{' '.join(cmd)}\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    return Built(source, out, secs, log)


def build(sources: Iterable[Path]) -> List[Built]:
    """Compile every source that has no current build, all ``nvcc`` runs
    started together; returns one :class:`Built` per source."""
    sources = [Path(s).resolve() for s in sources]
    with _lock:
        jobs = [(s, *_start(s)) for s in sources if s not in _built]
        for s, out, job, t0 in jobs:
            _built[s] = _finish(s, out, job, t0)
        return [_built[s] for s in sources]


def load(source: Path, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """Build (if needed) and load one source's library.

    ``signatures`` maps each C function to ``(restype, argtypes)``; every
    pointer and the stream must be ``ctypes.c_void_p`` so ctypes does not
    cut them to 32-bit ints.
    """
    source = Path(source).resolve()
    with _lock:
        lib = _loaded.get(source)
    if lib is not None:
        return lib
    built = build([source])[0]
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(built.path))
            for name, (restype, argtypes) in signatures.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = list(argtypes)
            _loaded[source] = lib
        return lib


def raise_on(rc: int, fn: str, lib: ctypes.CDLL) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code (each
    library exports ``error_string``)."""
    if rc != 0:
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {rc} "
                           f"({lib.error_string(rc).decode()})")
