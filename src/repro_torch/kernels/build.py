"""Build and load the port's hand-written CUDA kernels.

Each source under ``src/repro_torch/csrc/`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface and
loaded with ctypes, so no PyTorch header is ever compiled.  Libraries go
into ``build/kernels/`` at the repository root (listed in ``.gitignore``)
under a name that carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt
and a stale library is never loaded.  ``build()``
starts one ``nvcc`` per missing library, all at once, and waits for all.

Nothing here runs at import time: the CPU tests import every module of
the port, and this machine class has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parents[1] / "build" / "kernels"

# library name -> source file under csrc/
SOURCES = {"tree_attention_paged": "tree_attention_paged.cu",
           "flash_attention": "flash_attention.cu",
           "mla_attention_paged": "mla_attention_paged.cu",
           "linear_attn_chunk": "linear_attn_chunk.cu",
           "linear_attn_chunk_bwd": "linear_attn_chunk_bwd.cu",
           "flash_attention_bwd": "flash_attention_bwd.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / SOURCES[name]).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=None) -> dict:
    """Compile every missing library in ``names`` (default: all), one
    ``nvcc`` process per source, all started together.  Returns
    ``{name: (seconds, ptxas report)}`` for the ones built; raises with
    the compiler's output if any build fails.  Each report is also saved
    beside its library, for ``ptxas_report``."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    built, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        report = "\n".join(ln for ln in log.splitlines()
                           if "ptxas info" in ln or "bytes stack frame" in ln)
        out.with_suffix(".ptxas").write_text(report)
        os.replace(tmp, out)
        built[name] = (secs, report)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return built


def ptxas_report(name: str) -> str:
    """The ``ptxas -v`` report (registers, stack frame, spills) saved
    beside the library when it was built; builds it first if missing."""
    path = library_path(name)
    if not path.exists():
        build([name])
    return path.with_suffix(".ptxas").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if missing."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
