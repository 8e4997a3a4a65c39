"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface and becomes one shared
library, compiled by ``nvcc`` for ``sm_90a`` (Hopper) at first use and
loaded with ``ctypes``.  Libraries are named after a hash of their source
and flags, so an edited source is rebuilt and never mixed up with an old
build.  Builds go to ``ncnet_tpu_torch/_build/`` (listed in ``.gitignore``);
``build()`` compiles every missing library with one ``nvcc`` per source,
all started together.  Nothing here runs at import: this module is imported
on machines with no CUDA toolkit, where only the plain twins run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("nc_conv4d.cu", "nc_conv4d_vjp.cu", "gather_tile_corr.cu",
           "conv4d_small_cout.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-lineinfo",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc (the CUDA toolkit) was not found: the port's CUDA kernels are "
        "built from source at first use on a machine with the toolkit")


def library_path(source: str) -> Path:
    text = (CSRC_DIR / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(text).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(source).stem}_{digest}.so"


def build(sources: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every library that is not built yet, all in parallel.

    Returns ``{source: compiler output}`` for the sources compiled by this
    call (``-Xptxas=-v`` makes that output the registers, shared memory and
    spills of each kernel).  Raises ``RuntimeError`` with the compiler's
    output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for src in sources:
        lib = library_path(src)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.{time.monotonic_ns()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, lib)
    logs, failed = {}, []
    for src, (proc, tmp, lib) in procs.items():
        logs[src] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(src)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)  # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[s][-4000:] for s in failed))
    return logs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    build([source])
    return ctypes.CDLL(str(library_path(source)))
