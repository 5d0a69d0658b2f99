"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file compiles on first use into its own shared library
with a plain C interface (bound with ``ctypes``): one ``nvcc`` per source,
all started together. Libraries land in ``build/kernels-<hash>/`` at the
repository root, keyed by a hash of the sources and flags, so an edited
source never loads a stale library. Each compile's ``-Xptxas -v`` report
(registers, shared memory, spills) is kept beside its library as
``<name>.log``.

Worker threads launch kernels on their own streams at once, so the build,
the lookups and the wrappers' launch counts each go under a lock here.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # One rounding per float op, like the plain versions: no multiply is
    # contracted into an add as an FMA.
    "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}  # guarded-by: _LOAD_LOCK
_FUNCTIONS: dict[tuple[str, str], ctypes._CFuncPtr] = {}  # guarded-by: _LOAD_LOCK
# One build at a time: two threads' first uses must not run nvcc twice into
# the same files. Reentrant, since ``function`` loads.
_LOAD_LOCK = threading.RLock()
# Held by every wrapper around its launch count's read-modify-write, so
# launches from concurrent threads are each counted once.
COUNT_LOCK = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (shutil.which("nvcc"), CUDA_HOME and os.path.join(CUDA_HOME, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build_dir() -> pathlib.Path:
    """``build/kernels-<hash of sources and flags>``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / f"kernels-{h.hexdigest()[:16]}"


def build_all() -> dict[str, pathlib.Path]:
    """Compile every source not yet built, in parallel; name -> library."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {p.stem: out_dir / f"lib{p.stem}.so" for p in sorted(CSRC.glob("*.cu"))}
    procs = []
    for name, lib in libs.items():
        if lib.exists():
            continue
        tmp = out_dir / f".lib{name}.{os.getpid()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode:
            failed.append(f"{name}.cu:\n{log}")
        else:
            os.replace(tmp, libs[name])  # atomic: a racing build never sees half a file
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    with _LOAD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build_all()[name]))
        return lib


def function(lib_name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """A C entry point of ``csrc/<lib_name>.cu`` with its argument types
    declared (``c_void_p`` for pointers and the stream, so none is cut to
    32 bits) and an ``int`` (``cudaError_t``) result. Looked up once: later
    calls return the bound entry point."""
    with _LOAD_LOCK:
        fn = _FUNCTIONS.get((lib_name, symbol))
        if fn is None:
            fn = getattr(load(lib_name), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _FUNCTIONS[lib_name, symbol] = fn
        return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def require(t, name: str, dtype, shape: tuple, device) -> None:
    """Validate a tensor handed to a kernel: device, dtype, shape, layout."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream_of(device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
