"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, ``build/lib<name>-<hash>.so``
at the repo root, and loaded with ``ctypes``.  Nothing but ``csrc/`` goes
into a build.  The file name carries a hash of the sources and flags, so
an edited kernel is rebuilt and a stale library is never loaded.  The
build runs at first use (or up front through :func:`build`, which starts
one ``nvcc`` per source, all at once); nothing is compiled at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
KERNELS = ("spmm_ell_fused", "spmm_bcsr_fused", "spmm_ell_fused_staged",
           "spmm_bcsr_fused_staged", "attn_fused", "attn_fused_staged",
           "sddmm", "spmm_ell_segment", "spmm_bcsr")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> nvcc's output for the last build here (ptxas register and
# spill report), for the smoke run to print
BUILD_LOG: Dict[str, str] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME — the CUDA "
            "kernels are compiled from source at first use")
    return str(path)


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Sequence[str] = KERNELS) -> Dict[str, float]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together.  Returns the
    wall seconds each build took (0.0 for a library already built) and
    raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds = {name: 0.0 for name in names}
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def _open(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def load(name: str, argtypes: Sequence) -> ctypes.CDLL:
    """The loaded library for ``name`` (built first if needed).  Its C
    entry point ``<name>_launch`` gets ``argtypes`` and an ``int``
    return, the ``cudaError_t`` of the launch."""
    lib = _open(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def ctas_per_sm(name: str, bm: int, smem: int, *, threads: int = 0) -> int:
    """How many CTAs of ``name``'s kernel at row block ``bm`` (one of
    the sizes the wrappers accept) the current card fits on one SM with
    ``smem`` bytes of dynamic shared memory, as
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` reports it through
    the library's ``<name>_ctas_per_sm``.  With ``threads``, K1's and
    K10's one-thread-a-column route instead, in CTAs of that many threads
    (``<name>_narrow_ctas_per_sm``; ``smem`` is then ignored)."""
    query = f"{name}_narrow_ctas_per_sm" if threads else f"{name}_ctas_per_sm"
    fn = getattr(_open(name), query)
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    n = fn(bm, threads or smem)
    if n < 0:
        raise RuntimeError(f"the occupancy query {query} failed "
                           f"(bm={bm}, smem={smem}, threads={threads})")
    return n
