"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by
``nvcc`` for ``sm_90a`` into ``build/lib<name>-<hash>.so`` next to this
file (a directory ``.gitignore`` lists) and loaded with :mod:`ctypes`.
The hash is of the source, so an edited source is rebuilt and an
unchanged one is reused. Nothing is built at import time: the first
call that needs a kernel builds it.

:func:`build` starts one ``nvcc`` per source, all at once, so the
build of several kernels takes about as long as the slowest one.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable

__all__ = ["BuiltLibrary", "build", "load", "nvcc_path"]

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass
class BuiltLibrary:
    """A loaded kernel library and how it was built."""

    name: str
    path: str
    lib: ctypes.CDLL
    seconds: float  # build time, 0.0 when an earlier build was reused
    log: str  # nvcc's output, with -Xptxas -v's registers and spills


_LOADED: Dict[str, BuiltLibrary] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``$CUDA_HOME``
    (by default the toolkit's usual ``/usr/local/cuda``). Raises
    ``RuntimeError`` when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from source at first "
        "use and need the CUDA toolkit"
    )


def _target(name: str) -> tuple:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")
    return src, so


def build(names: Iterable[str]) -> Dict[str, BuiltLibrary]:
    """Build (where needed) and load the named kernels; one ``nvcc``
    process per source, all started together. Raises ``RuntimeError``
    with the compiler's output if any build fails."""
    names = [n for n in dict.fromkeys(names) if n not in _LOADED]
    procs = {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    for name in names:
        src, so = _target(name)
        if os.path.exists(so):
            continue
        # Build to a private name, then rename: concurrent builds of the
        # same source never load a half-written library.
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs[name] = (proc, tmp, so, time.perf_counter())
    failures = []
    logs: Dict[str, tuple] = {}
    for name, (proc, tmp, so, t0) in procs.items():
        out, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{out}")
            continue
        os.replace(tmp, so)
        with open(so + ".log", "w") as fh:
            fh.write(out)
        logs[name] = (seconds, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    for name in names:
        _, so = _target(name)
        seconds, log = logs.get(name, (0.0, None))
        if log is None:
            log = ""
            if os.path.exists(so + ".log"):
                with open(so + ".log") as fh:
                    log = fh.read()
        _LOADED[name] = BuiltLibrary(name, so, ctypes.CDLL(so), seconds, log)
    return dict(_LOADED)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built on first use."""
    if name not in _LOADED:
        build([name])
    return _LOADED[name].lib
