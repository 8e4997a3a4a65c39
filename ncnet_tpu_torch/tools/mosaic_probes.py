"""T2: a battery of minimal CUDA kernels, one Hopper primitive each.

The JAX tool ``tools/mosaic_probes.py`` compiles minimal Pallas kernels,
each using one layout-sensitive operation, "so the redesign composes only
known-good primitives".  Here the counterpart, under the same module name
and the names ``PROBES`` and ``_compile``, is CUDA: one source per probe in
``csrc/probes/`` (a plain-C entry ``probe_run``), built for ``sm_90a`` by
``ops/kernel_build.py``.  The probes check the primitives the tensor-core
redesigns of the NC kernels (ROADMAP B6–B8) will be built from, at the NC
stack's own shapes (rows of C = 16 bf16 channels, 32 bytes; padded rows of
29 cells; the (p, q, c) = 400 contraction): ``mma.sync``, ``ldmatrix``,
``stmatrix``, ``cp.async``, ``mbarrier`` phases, bulk copies, TMA loads and
stores (with the zero fill outside the volume), ``wgmma`` from shared
memory and from registers, the 128-byte swizzle, ``setmaxnreg``, clusters
with distributed shared memory, and the 227 KB shared-memory opt-in.
``port_kernels`` is the counterpart of ``probe_old_kernel``: every
``csrc/*.cu`` of the port builds anew for ``sm_90a`` (the build log carries
each kernel's registers and spills).

A probe passes when its source builds, its kernel launches on seeded
inputs and finishes, and its output equals the plain torch twin's: copies
bit for bit, products within 1e-5 of the twin's largest output (the
product probes feed small integers, which f32 sums exactly, so they agree
bit for bit too).  A wrong descriptor or box compiles fine and returns
garbage, so a build alone is not a pass.  A probe that does not build, does
not launch or disagrees is that probe's FAIL, reported; nothing runs in
its place.

Run on the card from the repository root::

    python3 -m ncnet_tpu_torch.tools.mosaic_probes            # all probes
    python3 -m ncnet_tpu_torch.tools.mosaic_probes wgmma_m64n16k16_ss

It prints one ``PASS name`` / ``FAIL name: message`` line per probe and
exits non-zero when any probe fails (the JAX tool exits 0 either way; here
a FAIL means a primitive the next kernels need is unusable on this card).
With ``device="cpu"`` (the tests) nothing is built or launched, and each
twin is held against its numpy reference instead.

``launches`` counts the probe kernels launched in this process (one per
probe run on the card).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import functools
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ncnet_tpu_torch.models.ncnet import resolve_device
from ncnet_tpu_torch.ops import kernel_build

#: probe kernels launched since the process started (or the caller reset it)
launches = 0
SEED = 0
# products against their twin: |kernel - twin| <= RTOL * max|twin|
RTOL = 1e-5
PORT_KERNELS = "port_kernels"
# cudaError_t codes after which the process's CUDA context is unusable
# (illegal address, launch timeout, hardware stack error, illegal
# instruction, misaligned address, invalid address space, invalid pc,
# launch failure): every later probe would fail on its first CUDA call
STICKY_ERRORS = frozenset((700, 702, 714, 715, 716, 717, 718, 719))


@dataclasses.dataclass(frozen=True)
class Probe:
    """One probe: ``inputs(generator)`` makes its CPU inputs (one or two);
    ``twin`` is the plain torch version of its kernel; ``reference`` the
    same in numpy (on float32 or integer arrays); ``exact``: a copy,
    compared bit for bit; ``log_forbids``: build-log text that fails it."""

    inputs: Callable[[torch.Generator], Tuple[torch.Tensor, ...]]
    twin: Callable[..., torch.Tensor]
    reference: Callable[..., np.ndarray]
    exact: bool = True
    log_forbids: Tuple[str, ...] = ()


def _normal(g, shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=g).to(dtype)


def _ints(g, shape, dtype=torch.bfloat16):
    """Small integers: every product and sum of the product probes is
    exact in f32, so the kernel and its twin agree bit for bit."""
    return torch.randint(-8, 9, shape, generator=g).to(dtype)


def _product(a, b_t):
    return a.float() @ b_t.float().t()


def _np_product(a, b_t):
    return (a.astype(np.float64) @ b_t.astype(np.float64).T).astype(np.float32)


# --- fragment maps: lane l, matrix m, pair element h of ldmatrix/stmatrix x4
_CELL0 = 3  # the four 8 x 8 matrices start at cell 3 (an odd offset)


def _fragment_index(transposed: bool):
    """(cell, channel) indices, each (32, 4, 2), of lane l's register m,
    half h: matrix m = cells 3 + 8 (m // 2) .., channels 8 (m % 2) ..; the
    lane holds row l // 4, columns 2 (l % 4) + h (``transposed``: column
    l // 4, rows 2 (l % 4) + h)."""
    lane = torch.arange(32).view(32, 1, 1)
    m = torch.arange(4).view(1, 4, 1)
    h = torch.arange(2).view(1, 1, 2)
    row, col = lane // 4, 2 * (lane % 4) + h
    if transposed:
        row, col = col, row
    cell = _CELL0 + 8 * (m // 2) + row
    ch = 8 * (m % 2) + col
    return torch.broadcast_tensors(cell, ch)


def _ldmatrix_twin(transposed):
    def twin(x):
        cell, ch = _fragment_index(transposed)
        return x[cell, ch]
    return twin


def _ldmatrix_ref(transposed):
    def ref(x):
        out = np.zeros((32, 4, 2), x.dtype)
        for lane in range(32):
            for m in range(4):
                for h in range(2):
                    r, c = lane // 4, 2 * (lane % 4) + h
                    if transposed:
                        r, c = c, r
                    out[lane, m, h] = x[_CELL0 + 8 * (m // 2) + r,
                                        8 * (m % 2) + c]
        return out
    return ref


def _stmatrix_twin(frags):
    out = torch.zeros((29, 16), dtype=frags.dtype)
    cell, ch = _fragment_index(False)
    out[cell, ch] = frags
    return out


def _stmatrix_ref(frags):
    out = np.zeros((29, 16), frags.dtype)
    for lane in range(32):
        for m in range(4):
            for h in range(2):
                out[_CELL0 + 8 * (m // 2) + lane // 4,
                    8 * (m % 2) + 2 * (lane % 4) + h] = frags[lane, m, h]
    return out


# --- TMA boxes over the (B hA, wA, hB, wB, C) = (4, 5, 25, 25, 16) volume
VOLUME = (4, 5, 25, 25, 16)


def _tma_load_twin(v):
    """Box 0 at (wB, hB) = (-2, -2) of plane (2, 1): the plane's zero-padded
    29 x 29 frame; box 1 at (1, 0) of plane (3, 4), past the far edges."""
    return torch.stack([F.pad(v[2, 1], (0, 0, 2, 2, 2, 2)),
                        F.pad(v[3, 4, :, 1:], (0, 0, 0, 5, 0, 4))])


def _tma_load_ref(v):
    out = np.zeros((2, 29, 29, 16), v.dtype)
    for n, (plane, w0, h0) in enumerate((((2, 1), -2, -2), ((3, 4), 1, 0))):
        for h in range(29):
            for w in range(29):
                hb, wb = h0 + h, w0 + w
                if 0 <= hb < 25 and 0 <= wb < 25:
                    out[n, h, w] = v[plane][hb, wb]
    return out


def _tma_store_twin(tile):
    """The box stored at (wB, hB) = (0, 0) of plane (2, 1) and at (10, 12)
    of plane (0, 0), clipped at the far edges (a TMA store must start
    inside the volume)."""
    out = torch.zeros(VOLUME, dtype=tile.dtype)
    out[2, 1] = tile[:25, :25]
    out[0, 0, 12:25, 10:25] = tile[:13, :15]
    return out


def _tma_store_ref(tile):
    out = np.zeros(VOLUME, tile.dtype)
    for plane, w0, h0 in (((2, 1), 0, 0), ((0, 0), 10, 12)):
        for h in range(29):
            for w in range(29):
                hb, wb = h0 + h, w0 + w
                if hb < 25 and wb < 25:
                    out[plane][hb, wb] = tile[h, w]
    return out


# --- the fused-lane frame padded to 848 lanes: (B hA, wA, C, lanes)
LANES = (29, 29, 16, 848)


def _tma_848_twin(x):
    return torch.stack([x[7, 3:8, :, 712:848],
                        F.pad(x[28, 22:27, :, 760:848], (0, 48))])


def _tma_848_ref(x):
    out = np.zeros((2, 5, 16, 136), x.dtype)
    for n, (lane0, row0, plane) in enumerate(((712, 3, 7), (760, 22, 28))):
        for lane in range(136):
            if lane0 + lane < 848:
                out[n, :, :, lane] = x[plane, row0:row0 + 5, :, lane0 + lane]
    return out


def _setmaxnreg_weights():
    """(256, 32): consumer thread ct weighs input row i by i + ct."""
    return (torch.arange(32).view(1, 32) + torch.arange(256).view(256, 1)).float()


PROBES: Dict[str, Optional[Probe]] = {
    "mma_sync_m16n8k16_bf16": Probe(
        lambda g: (_ints(g, (16, 400)), _ints(g, (400, 8))),
        lambda a, b: a.float() @ b.float(),
        lambda a, b: (a.astype(np.float64) @ b).astype(np.float32),
        exact=False),
    "ldmatrix_x4": Probe(lambda g: (_normal(g, (29, 16)),),
                         _ldmatrix_twin(False), _ldmatrix_ref(False)),
    "ldmatrix_x4_trans": Probe(lambda g: (_normal(g, (29, 16)),),
                               _ldmatrix_twin(True), _ldmatrix_ref(True)),
    "stmatrix_x4": Probe(lambda g: (_normal(g, (32, 4, 2)),),
                         _stmatrix_twin, _stmatrix_ref),
    "cp_async_16": Probe(lambda g: (_normal(g, (4, 25, 25, 16)),),
                         lambda v: v[2, 2:10, 3:16],
                         lambda v: v[2, 2:10, 3:16].copy()),
    "mbarrier_parity": Probe(lambda g: (_normal(g, (16, 32), torch.float32),),
                             lambda x: 2 * x, lambda x: 2 * x),
    "cp_async_bulk": Probe(lambda g: (_normal(g, (4, 29, 16)),),
                           lambda v: v[2], lambda v: v[2].copy()),
    "tma_load_5d": Probe(lambda g: (_normal(g, VOLUME),),
                         _tma_load_twin, _tma_load_ref),
    "tma_store_5d": Probe(lambda g: (_normal(g, (29, 29, 16)),),
                          _tma_store_twin, _tma_store_ref),
    "tma_load_848_lanes": Probe(lambda g: (_normal(g, LANES),),
                                _tma_848_twin, _tma_848_ref),
    "wgmma_m64n16k16_ss": Probe(
        lambda g: (_ints(g, (64, 16)), _ints(g, (16, 16))),
        _product, _np_product, exact=False),
    "wgmma_m64n16k16_rs": Probe(
        lambda g: (_ints(g, (64, 16)), _ints(g, (16, 16))),
        _product, _np_product, exact=False),
    "wgmma_m64n8k16_ss": Probe(
        lambda g: (_ints(g, (64, 16)), _ints(g, (8, 16))),
        _product, _np_product, exact=False),
    "wgmma_k400_swizzle128": Probe(
        lambda g: (_ints(g, (64, 400)), _ints(g, (16, 400))),
        _product, _np_product, exact=False),
    "setmaxnreg": Probe(
        lambda g: (_ints(g, (32, 64), torch.float32),),
        lambda x: _setmaxnreg_weights() @ x,
        lambda x: (np.arange(32)[None, :] + np.arange(256)[:, None]
                   ).astype(np.float64) @ x,
        exact=False, log_forbids=("setmaxnreg",)),
    "cluster_dsmem": Probe(lambda g: (_normal(g, (256,), torch.float32),),
                           lambda x: torch.cat([x[128:], x[:128]]),
                           lambda x: np.concatenate([x[128:], x[:128]])),
    "smem_optin_227k": Probe(
        lambda g: (torch.randint(-2 ** 31, 2 ** 31 - 1, (232448 // 4,),
                                 generator=g, dtype=torch.int32),),
        lambda x: x.flip(0), lambda x: x[::-1].copy()),
    # builds every port source anew; no kernel of its own, so no twin
    PORT_KERNELS: None,
}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({torch.bfloat16: torch.int16, torch.float32: torch.int32}
                  .get(t.dtype, t.dtype))


def _compare(got: torch.Tensor, want: torch.Tensor, exact: bool) -> str:
    if got.shape != want.shape or got.dtype != want.dtype:
        return (f"FAIL: output {tuple(got.shape)} {got.dtype}, twin "
                f"{tuple(want.shape)} {want.dtype}")
    if exact:
        diff = int((_bits(got) != _bits(want)).sum())
        return "PASS" if diff == 0 else f"FAIL: {diff} of {want.numel()} elements differ from the twin"
    err = float((got.double() - want.double()).abs().max())
    tol = RTOL * float(want.double().abs().max())
    return "PASS" if err <= tol else f"FAIL: max |kernel - twin| {err:.4g} > {tol:.4g}"


def _first_error(log: str) -> str:
    lines = [ln.strip() for ln in log.splitlines() if ln.strip()]
    errors = [ln for ln in lines if "error" in ln.lower()]
    return ((errors or lines or ["build failed"])[0])[:160]


# (built, compiler output) of port_kernels in this process
_port_build: Optional[Tuple[bool, str]] = None


def _build_port_kernels() -> Tuple[bool, str]:
    global _port_build
    if _port_build is None:
        results = kernel_build.compile_fresh(kernel_build.SOURCES)
        order = sorted(results, key=lambda src: results[src][0])  # failed first
        _port_build = (all(ok for ok, _ in results.values()),
                       "\n".join(f"== {src}\n{results[src][1]}" for src in order))
    return _port_build


def _compile(name: str, device=None) -> Tuple[bool, str]:
    """Build probe ``name``'s source (``port_kernels``: every port source
    anew): ``(built, compiler output)``.  The CPU runs the twins and builds
    nothing."""
    if resolve_device(device).type != "cuda":
        return True, ""
    if name == PORT_KERNELS:
        return _build_port_kernels()
    return kernel_build.build_probe(name)


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    lib = kernel_build.probe_library(name)
    lib.probe_run.argtypes = [ctypes.c_void_p] * 4
    lib.probe_run.restype = ctypes.c_int
    lib.probe_error_string.argtypes = [ctypes.c_int]
    lib.probe_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, xs: Sequence[torch.Tensor], out: torch.Tensor) -> int:
    """One launch of probe ``name`` on CUDA tensors; the C entry
    synchronises and returns 0 or an error code."""
    global launches
    lib = _library(name)
    ptrs = [x.data_ptr() for x in xs] + [None] * (2 - len(xs))
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = lib.probe_run(*ptrs, out.data_ptr(), stream)
    launches += 1
    return rc


def _check(name: str, log: str, dev: torch.device) -> str:
    probe = PROBES[name]
    if probe is None:  # port_kernels: the build was the check
        if dev.type == "cuda":
            return "PASS"
        on_disk = sorted(p.name for p in kernel_build.CSRC_DIR.glob("*.cu"))
        return ("PASS" if on_disk == sorted(kernel_build.SOURCES) else
                f"FAIL: csrc/ holds {on_disk}, SOURCES lists "
                f"{sorted(kernel_build.SOURCES)}")
    for text in probe.log_forbids:
        hits = [ln.strip() for ln in log.splitlines()
                if text in ln and "warning" in ln.lower()]
        if hits:
            return "FAIL: " + hits[0][:160]
    xs = probe.inputs(torch.Generator().manual_seed(SEED))
    want = probe.twin(*xs)
    if dev.type != "cuda":
        ref = torch.from_numpy(np.ascontiguousarray(
            probe.reference(*[_to_numpy(x) for x in xs])))
        return _compare(ref.to(want.dtype), want, probe.exact)
    ins = [x.to(dev).contiguous() for x in xs]
    out = torch.zeros(want.shape, dtype=want.dtype, device=dev)
    rc = _launch(name, ins, out)
    if rc != 0:
        return f"FAIL: {_library(name).probe_error_string(rc).decode()} ({rc})"
    return _compare(out.cpu(), want, probe.exact)


def _names(names: Optional[Sequence[str]]) -> List[str]:
    names = list(names) if names else list(PROBES)
    unknown = [n for n in names if n not in PROBES]
    if unknown:
        raise KeyError(f"unknown probes {unknown}; known: {sorted(PROBES)}")
    return names


def run(names: Optional[Sequence[str]] = None, device=None) -> Dict[str, str]:
    """``{name: "PASS" | "FAIL: <first error line>"}`` for the probes
    ``names`` (all by default).  On the card every source is built first,
    all at once."""
    dev = resolve_device(device)
    names = _names(names)
    if dev.type == "cuda":
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            jobs = [pool.submit(kernel_build.build_probes,
                                [n for n in names if n != PORT_KERNELS])]
            if PORT_KERNELS in names:
                jobs.append(pool.submit(_build_port_kernels))
            for job in jobs:
                job.result()
    results, lost = {}, None
    for name in names:
        built, log = _compile(name, dev)
        if not built:
            results[name] = "FAIL: " + _first_error(log)
        elif lost is not None:
            results[name] = f"FAIL: not run: the CUDA context was lost to {lost}"
        else:
            results[name] = _check(name, log, dev)
            if results[name].endswith(tuple(f"({rc})" for rc in STICKY_ERRORS)):
                lost = name
    return results


def port_kernel_spills() -> Dict[str, List[str]]:
    """Per port source, the ptxas lines of its last fresh build that report
    a spill (empty: none), from ``port_kernels``."""
    _, log = _port_build or (False, "")
    spills, src = {}, None
    for line in log.splitlines():
        if line.startswith("== "):
            src = line[3:]
            spills[src] = []
        elif src and "spill" in line and not line.strip().endswith(
                "0 bytes spill stores, 0 bytes spill loads"):
            spills[src].append(line.strip())
    return spills


def report(results: Dict[str, str]) -> None:
    """Print one ``PASS name`` / ``FAIL name: msg`` line per probe, the JAX
    tool's format, then the port sources' spills when ``port_kernels`` was
    built in this process."""
    for name, verdict in results.items():
        if verdict == "PASS":
            print(f"PASS {name}")
        else:
            print(f"FAIL {name}: {verdict[len('FAIL: '):]}")
    if PORT_KERNELS in results and _port_build is not None:
        print(f"port_kernels spills: {port_kernel_spills()}")
    sys.stdout.flush()


def main(argv: Optional[List[str]] = None, device=None) -> int:
    """``[name ...]``: run the probes (all by default) and :func:`report`
    them; returns 1 when any probe failed, else 0."""
    args = sys.argv[1:] if argv is None else list(argv)
    results = run(args or None, device)
    report(results)
    return int(any(v != "PASS" for v in results.values()))


if __name__ == "__main__":
    sys.exit(main())
