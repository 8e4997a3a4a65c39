"""T1's design choices, timed on the card: variants of ``csrc/conv_l2_fused_lane.cu``.

Each variant is the kernel source with some of its compile-time constants
replaced (``kNL``: 32-cell groups a block, ``kMinBlocks``: blocks an SM,
``kStages``: the copy ring's depth, ``kRP``: cells a row of the scratch),
built with ``kernel_build.NVCC_FLAGS`` into ``_build/variants/`` (one
``nvcc`` each, all at once), then launched in a process of its own, so
that a fault loses only that variant.  For each it prints the build's
registers and spills, and at B = 8 with bf16 and f32 Y terms, on phase T's
inputs (``torch.Generator`` seed 8): the normalized error against the
twin, the share of nonzero interior outputs bit-equal to the twin of its Y
dtype and to the other's, whether two launches are bit-identical and the
halo lanes zero, and ms per launch (CUDA events, two runs of 10 launches,
the weight packing and the pre-pass included).

Run on the card from the repository root::

    python3 -m ncnet_tpu_torch.tools.l2_variants [name ...]

It prints the card's name and power limit, then one ``build`` line and
one ``variant`` JSON line per variant; it exits non-zero if a variant
fails.  Without CUDA it raises.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

import torch

from ncnet_tpu_torch.models.ncnet import resolve_device
from ncnet_tpu_torch.ops import kernel_build
from ncnet_tpu_torch.tools import pallas_l2_probe as l2

#: name -> the constants it replaces; "kept" is the source as it is
VARIANTS: Dict[str, Dict[str, int]] = {
    "kept": {},
    "two_stages": {"kStages": 2},
    "four_stages": {"kStages": 4},
    # two blocks of 64 cells an SM: at most 96 registers a thread
    "two_blocks_of_64": {"kNL": 2, "kMinBlocks": 2},
    # rows of 29 cells: 8 cells that straddle a row end share banks
    "rows_of_29": {"kRP": 29},
}
BATCH = 8
VARIANT_DIR = kernel_build.BUILD_DIR / "variants"


def variant_source(subs: Dict[str, int], text: str) -> str:
    """``text`` with each ``constexpr int <name> = <n>;`` of ``subs`` set to
    its value; raises if a constant is not defined exactly once."""
    for name, value in subs.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise ValueError(f"{name} is defined {n} times in {l2.SOURCE}")
    return text


def build(names: List[str]) -> Dict[str, Path]:
    """Compile the variants ``names`` all at once; prints one line each
    (registers, spills) and returns the libraries that built."""
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    text = (kernel_build.CSRC_DIR / l2.SOURCE).read_text()
    procs = {}
    for name in names:
        # beside the source, so that its #include finds tensor_core.cuh
        src = kernel_build.CSRC_DIR / f"_variant_{name}.cu"
        src.write_text(variant_source(VARIANTS[name], text))
        lib = VARIANT_DIR / f"lib_{name}.so"
        procs[name] = (subprocess.Popen(
            [kernel_build._nvcc(), *kernel_build.NVCC_FLAGS, "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), src, lib)
    built = {}
    for name, (proc, src, lib) in procs.items():
        log = proc.communicate()[0]
        src.unlink()
        lines = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                 if "Used" in ln or "spill" in ln]
        print(f"build {name}: rc {proc.returncode}; " + " | ".join(lines),
              flush=True)
        if proc.returncode == 0:
            built[name] = lib
        else:
            print(log[-3000:], flush=True)
    return built


def measure(name: str, lib_path: Path) -> Dict:
    """The checks and times of one built variant (see the module doc)."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = ctypes.CDLL(str(lib_path))
    lib.conv_l2_fused_lane.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.conv_l2_fused_lane_scratch_bytes.argtypes = [ctypes.c_int]
    lib.conv_l2_fused_lane_scratch_bytes.restype = ctypes.c_longlong

    def launch(xp, w2, bias, mask, ydt):
        wt = l2.pack_b_tiles(w2)
        scratch = torch.empty(lib.conv_l2_fused_lane_scratch_bytes(BATCH),
                              dtype=torch.uint8, device=dev)
        out = torch.empty((BATCH, l2.S, l2.S, l2.C, l2.KL),
                          dtype=torch.bfloat16, device=dev)
        rc = lib.conv_l2_fused_lane(
            xp.data_ptr(), wt.data_ptr(), bias.data_ptr(), mask.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), BATCH,
            int(ydt == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name}: launch failed with {rc}")
        return out

    g = torch.Generator().manual_seed(8)
    x = (torch.randn((BATCH,) + (l2.S,) * 4 + (l2.C,), generator=g) * 0.1
         ).to(dev, torch.bfloat16)
    w = (torch.randn((l2.K,) * 4 + (l2.C, l2.C), generator=g) * 0.05
         ).to(dev, torch.bfloat16)
    bias = (torch.randn((l2.C,), generator=g) * 0.1).to(dev, torch.bfloat16)
    args = (l2.to_fused_layout(x), l2.pack_weight(w),
            bias.float().contiguous(), l2.make_mask(dev).float().reshape(l2.KL))
    twins = {n: l2.conv_l2_reference(*args[:2], bias.reshape(1, l2.C, 1),
                                     l2.make_mask(dev), ydt=ydt)
             for n, ydt in l2.YDTS.items()}
    result = {"name": name}
    for ydt_name, ydt in l2.YDTS.items():
        got, again = launch(*args, ydt), launch(*args, ydt)
        torch.cuda.synchronize()
        want = twins[ydt_name]
        other = twins["f32" if ydt_name == "bf16" else "bf16"]
        runs = []
        for _ in range(2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                launch(*args, ydt)
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end) / 10)
        result[ydt_name] = {
            "normalized_err": float((got.float() - want.float()).abs().max())
            / float(want.float().abs().max()),
            "bit_equal_share": l2.bit_equal_share(got, want),
            "control_bit_equal_share": l2.bit_equal_share(got, other),
            "bit_identical": bool(torch.equal(got, again)),
            "halo_zero": not (got[..., :l2.LO].any()
                              or got[..., l2.LO + l2.NT:].any()),
            "ms_runs": runs}
    return result


def main(argv: Optional[List[str]] = None) -> int:
    """``[name ...]`` (default: every variant); see the module doc."""
    names = list(sys.argv[1:] if argv is None else argv) or list(VARIANTS)
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        raise ValueError(f"unknown variants {unknown}; known: {sorted(VARIANTS)}")
    resolve_device()  # raises without CUDA: variants are card builds
    print(l2.card_line(), flush=True)
    built = build(names)
    failed = len(built) < len(names)
    for name, lib in built.items():
        proc = subprocess.run(
            [sys.executable, "-c",
             "import json, sys; from pathlib import Path; "
             "from ncnet_tpu_torch.tools import l2_variants as v; "
             "print('variant ' + json.dumps(v.measure(sys.argv[1], "
             "Path(sys.argv[2]))))", name, str(lib)],
            capture_output=True, text=True)
        print(proc.stdout.strip(), flush=True)
        if proc.returncode != 0:
            failed = True
            print(f"variant {name} failed: {proc.stderr[-2000:]}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
