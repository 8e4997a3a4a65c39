"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface and becomes one shared
library, compiled by ``nvcc`` for ``sm_90a`` (Hopper) at first use and
loaded with ``ctypes``.  Libraries are named after a hash of their source,
the headers beside it and the flags, so an edited source is rebuilt and
never mixed up with an old build.  Builds go to ``ncnet_tpu_torch/_build/``
(listed in ``.gitignore``); ``build()`` compiles every missing library with
one ``nvcc`` per source, all started together.  The toolchain probes of
``tools/mosaic_probes.py`` live in ``csrc/probes/``, one source each;
``build_probes()`` compiles them the same way but reports a failed build as
that probe's result instead of raising.  Nothing here runs at import: this
module is imported on machines with no CUDA toolkit, where only the plain
twins run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
PROBE_DIR = CSRC_DIR / "probes"
BUILD_DIR = PACKAGE_DIR / "_build"
# the NC kernels one library a kernel size (k = 1, 3, 5, 7), so their
# builds run in parallel
SOURCES = tuple(f"nc_conv4d{vjp}_k{k}.cu" for vjp in ("", "_vjp")
                for k in (1, 3, 5, 7)) + (
    "gather_tile_corr.cu", "conv4d_small_cout.cu", "conv_l2_fused_lane.cu")
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
    """``source`` is relative to ``csrc/`` (``probes/<name>.cu`` for a
    probe); the hash covers it, every ``.cuh`` beside it and the flags."""
    path = CSRC_DIR / source
    text = path.read_bytes() + " ".join(NVCC_FLAGS).encode()
    for header in sorted(path.parent.glob("*.cuh")):
        text += header.read_bytes()
    digest = hashlib.sha256(text).hexdigest()[:16]
    return BUILD_DIR / f"lib{path.stem}_{digest}.so"


def _spawn(src: str, out: Path) -> subprocess.Popen:
    return subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(out),
                             str(CSRC_DIR / src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _tmp(lib: Path) -> Path:
    return lib.with_suffix(f".{os.getpid()}.{time.monotonic_ns()}.tmp")


def _compile(sources: Iterable[str]) -> Dict[str, Tuple[bool, str]]:
    """``{source: (built, compiler output)}`` for every library of
    ``sources`` not built yet, one ``nvcc`` each, all started together."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sources:
        lib = library_path(src)
        if not lib.exists():
            tmp = _tmp(lib)
            procs[src] = (_spawn(src, tmp), tmp, lib)
    results = {}
    for src, (proc, tmp, lib) in procs.items():
        log = proc.communicate()[0]
        results[src] = (proc.returncode == 0, log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)  # atomic: a concurrent loader sees all or none
    return results


def build(sources: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every library that is not built yet, all in parallel.

    Returns ``{source: compiler output}`` for the sources compiled by this
    call (``-Xptxas=-v`` makes that output the registers, shared memory and
    spills of each kernel).  Raises ``RuntimeError`` with the compiler's
    output when a build fails."""
    results = _compile(sources)
    failed = [src for src, (ok, _) in results.items() if not ok]
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(results[s][1][-4000:] for s in failed))
    return {src: log for src, (_, log) in results.items()}


def compile_fresh(sources: Iterable[str]) -> Dict[str, Tuple[bool, str]]:
    """Compile ``sources`` anew, all at once, whether or not their libraries
    exist, and discard the results: ``{source: (built, compiler output)}``,
    that is whether this toolchain builds them now, and with what
    registers and spills."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sources:
        tmp = _tmp(library_path(src))
        procs[src] = (_spawn(src, tmp), tmp)
    results = {}
    for src, (proc, tmp) in procs.items():
        log = proc.communicate()[0]
        results[src] = (proc.returncode == 0, log)
        tmp.unlink(missing_ok=True)
    return results


# (built, compiler output) of every probe built in this process
_probe_results: Dict[str, Tuple[bool, str]] = {}


def build_probes(names: Iterable[str]) -> Dict[str, Tuple[bool, str]]:
    """Build the probes ``names`` (all at once) and return ``{name: (built,
    compiler output)}``.  A failed build is that probe's result: it is
    returned, not raised.  A library built by an earlier process reports
    ``(True, "")``: its compiler output is gone."""
    names = list(names)
    todo = [n for n in names if n not in _probe_results]
    results = _compile(f"probes/{n}.cu" for n in todo)
    for n in todo:
        _probe_results[n] = results.get(f"probes/{n}.cu", (True, ""))
    return {n: _probe_results[n] for n in names}


def build_probe(name: str) -> Tuple[bool, str]:
    """``(built, compiler output)`` of the probe ``csrc/probes/<name>.cu``."""
    return build_probes([name])[name]


def probe_library(name: str) -> ctypes.CDLL:
    """The loaded library of a probe that :func:`build_probe` built."""
    return ctypes.CDLL(str(library_path(f"probes/{name}.cu")))


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    build([source])
    return ctypes.CDLL(str(library_path(source)))
