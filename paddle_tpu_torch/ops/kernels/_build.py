"""Build and load the port's CUDA kernels.

Each ``paddle_tpu_torch/csrc/<name>.cu`` compiles with its own ``nvcc``
into ``paddle_tpu_torch/_build/lib<name>-<hash>.so`` (a plain C
interface, no PyTorch headers, so a build takes seconds), and loads with
``ctypes``. The hash covers the source and the flags, so an edited
source rebuilds and a stale library is never loaded. Builds run at first
use; `build` starts one compiler per stale source, all at once. The
hash also covers the shared headers (``csrc/*.cuh``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build", "load", "library_path"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the "
                           "port's kernels need nvcc")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    # the shared headers are part of every source's build
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Compile the named sources (default: every ``csrc/*.cu``) whose
    library is missing, one ``nvcc`` each, all started together.
    Returns ``{name: {"seconds", "log"}}`` for the sources it built (the
    log holds ptxas' register and shared-memory report, and is kept
    beside the library as ``lib<name>-<hash>.log``); raises
    ``RuntimeError`` with the compiler's output if any build fails."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    done, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            os.unlink(tmp)
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n"
                          f"{log}")
            continue
        # rename into place: a concurrent loader never sees half a file
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
        done[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return done


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.
    ``signatures`` maps each exported function to its ``argtypes``
    (pointers and the stream as ``c_void_p``, so ctypes never cuts a
    64-bit pointer to an int); every function returns an int error
    code."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib
