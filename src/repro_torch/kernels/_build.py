"""Build and load the hand-written CUDA kernels.

Every ``kernels/*/csrc/*.cu`` file is compiled on its own by ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface, and
loaded with ``ctypes``.  That takes seconds per file, where
``torch.utils.cpp_extension.load`` (whose sources include PyTorch's
headers) takes minutes.

A kernel's tile sizes and limits, which its launch plan in Python also
needs, are stated once, in its package's ``ops.NVCC_DEFINES``, and
given to ``nvcc`` as ``-D`` macros; the source defines none of them.

Libraries go to ``build/kernels/`` at the root of the checkout (listed
in ``.gitignore``), named by a hash of their source, flags and macros,
so a changed source is rebuilt and an unchanged one is reused.  They are
built at first use — never when a module is imported — or all at once,
in parallel, by :func:`build_all`.  A build failure raises; nothing
falls back to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib
import os
import pathlib
import shutil
import subprocess
import threading

_PKG = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-lineinfo") + ARCH_FLAGS

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def sources() -> dict[str, pathlib.Path]:
    """Kernel name (the ``.cu`` file's stem) -> source path."""
    return {p.stem: p for p in sorted(_PKG.glob("*/csrc/*.cu"))}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH); the "
            "CUDA kernels are built on the machine with the card")
    return found


def defines(src: pathlib.Path) -> tuple[str, ...]:
    """The ``-D`` flags of a kernel source: its package's
    ``ops.NVCC_DEFINES``, the constants its launch plan shares with it."""
    ops = importlib.import_module(
        f"repro_torch.kernels.{src.parent.parent.name}.ops")
    return tuple(f"-D{k}={v}" for k, v in ops.NVCC_DEFINES.items())


def _flags(src: pathlib.Path) -> tuple[str, ...]:
    return NVCC_FLAGS + defines(src)


def _lib_path(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(_flags(src)).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def _start(src: pathlib.Path) -> tuple[subprocess.Popen, pathlib.Path,
                                       pathlib.Path] | None:
    out = _lib_path(src)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(src), "-Xptxas", "-v", "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(src: pathlib.Path, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed on {src} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)            # atomic: concurrent builds agree
    return log


def build_all() -> dict[str, str]:
    """Compile every kernel source that is not built yet, one ``nvcc``
    per source, all started together.  Returns name -> compiler log
    (``-Xptxas -v``: registers, shared memory, spills); empty for
    libraries that were already built."""
    with _LOCK:
        srcs = sources()
        jobs = {name: _start(src) for name, src in srcs.items()}
        logs = {}
        for name, job in jobs.items():
            logs[name] = "" if job is None else _finish(srcs[name], job)
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        srcs = sources()
        if name not in srcs:
            raise KernelBuildError(f"no kernel source named {name!r}; "
                                   f"have {sorted(srcs)}")
        job = _start(srcs[name])
        if job is not None:
            _finish(srcs[name], job)
        lib = ctypes.CDLL(str(_lib_path(srcs[name])))
        _LIBS[name] = lib
        return lib


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point
    (a refused launch never runs, and a later synchronise would not
    report it)."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
