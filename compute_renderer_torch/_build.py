"""Build and load the hand-written CUDA kernels of ``csrc/`` and the host
libraries of ``native/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``. The library lands in
``build/torch_kernels/`` at the repository root, named by a hash of its
source, the shared ``csrc/*.cuh`` headers and the flags: it is built at
first use and rebuilt when any of them changes. Nothing here runs at
import time.

Flags: ``sm_90a`` (Hopper), ``-fmad=false`` so that no mul+add is
contracted into an FMA (the JAX package's arithmetic is contraction-free,
and contraction flips coverage exactly on triangle edges), and never
``--use_fast_math`` (its flush-to-zero and approximate division and square
root would change results).

The host libraries (``native/<name>.cpp``: the OBJ parser and the system
sampler) compile with the C++ compiler (``$CXX``, else ``g++``) at
``-O2 -fPIC -std=c++17 -shared`` into ``build/host_libs/``, keyed the same
way by a hash of the source and the flags (``host_library``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NATIVE = Path(__file__).resolve().parent / "native"
HOST_BUILD_DIR = BUILD_DIR.parent / "host_libs"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Loaded entry points by (source name, symbol): a loaded shared object
# lives as long as the process, so one handle is shared by every caller.
_ENTRIES: dict = {}
# Build records (seconds, compiler output) of the libraries this process
# compiled, for the smoke script's report.
BUILD_LOG: dict = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the shared
    headers of ``csrc/`` and the flags."""
    text = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        text += header.read_bytes()
    digest = hashlib.sha256(
        text + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the hashed library exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for csrc/{name}.cu:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    BUILD_LOG[name] = (time.perf_counter() - t0, proc.stdout + proc.stderr)
    return out


def host_library(name: str) -> Path:
    """Path of the built ``native/<name>.cpp`` library, compiled now unless
    the library of this source and these flags exists. A failed build
    raises with the compiler's output."""
    src = NATIVE / f"{name}.cpp"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    out = HOST_BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        raise RuntimeError(f"C++ compiler {cxx!r} not found: native/{name}"
                           ".cpp needs one (set CXX, or CRT_DISABLE_NATIVE=1 "
                           "for the pure-Python paths)")
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{cxx} failed for native/{name}.cpp:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def build_all(names) -> None:
    """Compile several sources at once, one ``nvcc`` each."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        for future in [pool.submit(build, name) for name in names]:
            future.result()


def entry(name: str, symbol: str, pointers: int, ints: int):
    """The C function ``symbol`` of ``csrc/<name>.cu`` (built and loaded if
    needed), taking ``pointers`` device pointers, ``ints`` ints and the
    stream, and returning a CUDA error code."""
    fn = _ENTRIES.get((name, symbol))
    if fn is None:
        fn = getattr(ctypes.CDLL(str(build(name))), symbol)
        fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _ENTRIES[(name, symbol)] = fn
    return fn


def check(status: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
