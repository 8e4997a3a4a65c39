"""The port's probe tools (``ncnet_tpu_torch/tools/``) on the CPU: T1's twin
and layout helpers against the JAX tool ``tools/pallas_l2_probe.py``, the
T2 battery's twins against numpy, the battery's report, the timing
harness's arithmetic, and the entry points' refusal to run without CUDA.

Tolerances:
  * T1's twin against the JAX ``conv_l2_pallas`` (run in interpret mode):
    one bf16 ulp of the largest output.  Both sum bf16 products in f32,
    round each Y term to the Y dtype at the same point and the output once
    to bf16, so only the order of the f32 (p, q, c) sums may differ;
  * the layout helpers: bit for bit (pure data movement);
  * T1's twin against relu(``conv4d(variant="unroll")`` + bias): the JAX
    tool's own check, relative error < 5 %;
  * each T2 twin against its numpy reference: copies bit for bit, the
    products (small integers, exact in f32 and f64) exactly;
  * the Y rounding: the twins of the two Y dtypes lie within both of the
    card's normalized tolerances of each other, so only the share of
    outputs that agree bit for bit tells them apart: a twin whose Y sums
    are formed in another order (float64, then f32) keeps at least 0.999 of
    the nonzero interior outputs, the other Y dtype's twin under 0.9.

The JAX tool reads ``sys.argv`` when it is imported (batch, j-chunk, Y
dtype) and imports ``_timing`` from ``tools/``, so the loader sets both.
"""

import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ncnet_tpu_torch.ops import kernel_build
from ncnet_tpu_torch.tools import _timing
from ncnet_tpu_torch.tools import l2_variants as tvar
from ncnet_tpu_torch.tools import mosaic_probes as tprobes
from ncnet_tpu_torch.tools import pallas_l2_probe as tl2

REPO = Path(__file__).resolve().parents[1]
YDTS = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}


def jax_l2_probe(monkeypatch, ydt_name):
    """The JAX tool as a module, batch 1, j-chunk 5, Y dtype ``ydt_name``."""
    monkeypatch.setattr(sys, "argv", ["pallas_l2_probe.py", "1", "5", ydt_name])
    monkeypatch.syspath_prepend(str(REPO / "tools"))
    spec = importlib.util.spec_from_file_location(
        f"_jax_pallas_l2_probe_{ydt_name}", REPO / "tools" / "pallas_l2_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def seeded_layer(batch=1, seed=0):
    """The JAX check's recipe: bf16 volume, weights and bias from numpy."""
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(batch, 25, 25, 25, 25, 16)) * 0.1, jnp.bfloat16)
    w = jnp.asarray(rng.normal(size=(5, 5, 5, 5, 16, 16)) * 0.05, jnp.bfloat16)
    b = jnp.asarray(rng.normal(size=(16,)) * 0.1, jnp.bfloat16)
    return x, w, b


def to_torch(a):
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)


def bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(x)) - 7)


# ---------------------------------------------------------------------------
# T1: the L2 layer probe
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ydt_name", ["bf16", "f32"])
def test_l2_twin_matches_jax_kernel(monkeypatch, ydt_name):
    jmod = jax_l2_probe(monkeypatch, ydt_name)
    assert jmod.YDT == YDTS[ydt_name][0]
    x, w, b = seeded_layer()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jmod.conv_l2_pallas(
            jmod.to_fused_layout(x), jmod.pack_weight(w), b.reshape(1, 16, 1),
            jmod.make_mask()).astype(jnp.float32))
    got = tl2.conv_l2_pallas(
        tl2.to_fused_layout(to_torch(x)), tl2.pack_weight(to_torch(w)),
        to_torch(b).reshape(1, 16, 1), tl2.make_mask("cpu"),
        ydt=YDTS[ydt_name][1])
    assert got.shape == want.shape == (1, 25, 25, 16, 841)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    peak = float(np.abs(want).max())
    assert peak > 0
    assert float(np.abs(got - want).max()) <= bf16_ulp(peak)
    # the halo lanes are zero in both
    assert not got[..., :60].any() and not got[..., 781:].any()


def test_l2_layout_helpers_match_jax(monkeypatch):
    jmod = jax_l2_probe(monkeypatch, "bf16")
    x, w, _ = seeded_layer(seed=3)
    xp = tl2.to_fused_layout(to_torch(x))
    assert torch.equal(xp, to_torch(jmod.to_fused_layout(x)))
    assert torch.equal(tl2.pack_weight(to_torch(w)), to_torch(jmod.pack_weight(w)))
    mask = tl2.make_mask("cpu")
    assert mask.dtype == torch.bfloat16
    assert torch.equal(mask, to_torch(jmod.make_mask()))
    y = xp[:, 2:27, 2:27]  # any (B, 25, 25, 16, 841) frame
    assert torch.equal(tl2.from_fused_layout(y),
                       to_torch(jmod.from_fused_layout(jnp.asarray(
                           y.float().numpy(), jnp.bfloat16))))
    # the layout round-trips the volume
    assert torch.equal(tl2.from_fused_layout(xp[:, 2:27, 2:27]),
                       to_torch(x))


@pytest.mark.parametrize("ydt_name", ["bf16", "f32"])
def test_l2_check_against_unroll_conv(ydt_name, capsys):
    """``check()`` on the CPU (the twin in the kernel's place), at batch 1:
    relu(unroll conv4d + bias) within the JAX check's 5 %, and the kernel
    call equal to its twin."""
    numbers = tl2.check("cpu", YDTS[ydt_name][1], batch=1)
    assert numbers["rel_err"] < 0.05
    assert numbers["twin_max_abs_err"] == 0.0
    out = capsys.readouterr().out
    assert out.startswith("parity: max abs err") and "parity vs twin" in out


def test_l2_wrapper_checks_its_arguments():
    xp = torch.zeros((1, 29, 29, 16, 841), dtype=torch.bfloat16)
    w2 = torch.zeros((400, 400), dtype=torch.bfloat16)
    bias, mask = torch.zeros((1, 16, 1)), tl2.make_mask("cpu")
    with pytest.raises(ValueError, match="xp must be"):
        tl2.conv_l2_pallas(xp[:, :28], w2, bias, mask)
    with pytest.raises(TypeError, match="bf16"):
        tl2.conv_l2_pallas(xp.float(), w2, bias, mask)
    with pytest.raises(TypeError, match="ydt"):
        tl2.conv_l2_pallas(xp, w2, bias, mask, ydt=torch.float16)
    # the CUDA wrapper never takes a CPU tensor, and never falls back
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        tl2.conv_l2_cuda(xp, w2, bias, mask)
    assert tl2.conv_l2_pallas(xp, w2, bias, mask).abs().max() == 0


def test_l2_b_tiles_are_a_permutation_of_the_packed_weight():
    """The kernel's B tiles hold w2[(p, q, c), (r, s, o)] at [(p, q), (r, s),
    2 (o // 8) + c // 8, c % 8, o % 8]: a permutation, and it round-trips."""
    _, w, _ = seeded_layer(seed=5)
    w2 = tl2.pack_weight(to_torch(w))
    wt = tl2.pack_b_tiles(w2)
    assert wt.shape == (25, 25, 4, 8, 8) and wt.dtype == torch.bfloat16
    assert wt.is_contiguous()
    pq, rs, c, o = np.meshgrid(*(np.arange(n) for n in (25, 25, 16, 16)),
                               indexing="ij")
    got = wt.float().numpy()[pq, rs, 2 * (o // 8) + c // 8, c % 8, o % 8]
    want = w2.float().numpy()[pq * 16 + c, rs * 16 + o]
    np.testing.assert_array_equal(got, want)
    # back to w2: each index appears once
    back = np.empty((400, 400), np.float32)
    back[pq * 16 + c, rs * 16 + o] = got
    np.testing.assert_array_equal(back, w2.float().numpy())


def test_l2_bit_equal_share_counts_nonzero_interior_outputs():
    got = torch.zeros((1, 25, 25, 16, 841), dtype=torch.bfloat16)
    want = got.clone()
    assert tl2.bit_equal_share(got, want) == 0.0  # nothing nonzero
    got[..., 60:64] = 1.0   # 4 interior lanes, each in 25 * 25 * 16 rows
    got[..., 87:89] = 1.0   # halo lanes (row 1 cells 27, 28): not counted
    want[..., 60:61] = 1.0
    assert tl2.bit_equal_share(got, want) == 0.25


def reordered_twin(xp, w2, bias, mask, ydt):
    """``conv_l2_reference`` with its Y sums formed in float64 and then
    rounded to f32: the same rounding points, the f32 sums' order changed."""
    b = xp.shape[0]
    w = w2.double()
    out = torch.zeros((b, 25, 25, 16, 841), dtype=xp.dtype)
    for bi in range(b):
        for i in range(25):
            rows = xp[bi, i:i + 5]
            a = torch.stack([rows[p, q:q + 25] for p in range(5)
                             for q in range(5)], dim=1)
            y = torch.matmul(w.t(), a.reshape(25, 400, 841).double()).float()
            y = y.to(ydt).float()
            acc = torch.zeros((25, 16, tl2.NT))
            for r in range(5):
                for s in range(5):
                    blk, off = (r * 5 + s) * 16, r * 29 + s
                    acc = acc + y[:, blk:blk + 16, off:off + tl2.NT]
            acc = torch.relu(acc + bias.float().reshape(1, 16, 1))
            m = mask.float().reshape(1, 1, 841)[..., tl2.LO:tl2.LO + tl2.NT]
            out[bi, i, :, :, tl2.LO:tl2.LO + tl2.NT] = (acc * m).to(xp.dtype)
    return out


@pytest.fixture(scope="module")
def l2_twins():
    """The twins of both Y dtypes at B = 1 on the seed-8 layer."""
    x, w, b = seeded_layer(batch=1, seed=8)
    args = (tl2.to_fused_layout(to_torch(x)), tl2.pack_weight(to_torch(w)),
            to_torch(b).reshape(1, 16, 1), tl2.make_mask("cpu"))
    return args, {name: tl2.conv_l2_reference(*args, ydt=ydt)
                  for name, ydt in tl2.YDTS.items()}


@pytest.mark.parametrize("ydt_name", ["bf16", "f32"])
def test_l2_only_bit_equality_sees_the_y_rounding(l2_twins, ydt_name):
    args, twins = l2_twins
    other = "f32" if ydt_name == "bf16" else "bf16"
    # the other Y dtype passes both of the card's normalized tolerances
    err = float((twins[other].float() - twins[ydt_name].float()).abs().max())
    err /= float(twins[ydt_name].float().abs().max())
    assert 0 < err <= min(1e-2, 2.0 ** -7)
    # but not the bit-equality share, which another sum order does pass
    reordered = reordered_twin(*args, tl2.YDTS[ydt_name])
    assert not torch.equal(reordered, twins[ydt_name])
    assert tl2.bit_equal_share(reordered, twins[ydt_name]) >= 0.999
    assert tl2.bit_equal_share(twins[other], twins[ydt_name]) < 0.9


def test_l2_variants_replace_the_kernel_constants():
    """Each timed variant of T1 is its source with those constants set; a
    constant the source does not define once is refused."""
    text = (kernel_build.CSRC_DIR / tl2.SOURCE).read_text()
    for name, subs in tvar.VARIANTS.items():
        got = tvar.variant_source(subs, text)
        changed = [(a, b) for a, b in zip(text.splitlines(), got.splitlines())
                   if a != b]
        assert len(changed) == sum(
            f"constexpr int {k} = {v};" not in text for k, v in subs.items()), name
        for k, v in subs.items():
            assert f"constexpr int {k} = {v};" in got
    assert tvar.variant_source({}, text) == text
    with pytest.raises(ValueError, match="kWarps2"):
        tvar.variant_source({"kWarps2": 1}, text)


def test_l2_variants_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("the refusal shows only where CUDA is not available")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tvar.main([])
    with pytest.raises(ValueError, match="unknown variants"):
        tvar.main(["no_such_variant"])


# ---------------------------------------------------------------------------
# T2: the probe battery
# ---------------------------------------------------------------------------


KERNEL_PROBES = [n for n, p in tprobes.PROBES.items() if p is not None]


def test_every_probe_has_a_source_and_a_twin():
    assert len(tprobes.PROBES) >= 15
    assert {p.stem for p in kernel_build.PROBE_DIR.glob("*.cu")} == set(KERNEL_PROBES)
    for name in KERNEL_PROBES:
        assert (kernel_build.PROBE_DIR / f"{name}.cu").is_file()
        probe = tprobes.PROBES[name]
        assert callable(probe.twin) and callable(probe.reference)
    # port_kernels builds the port's own sources: every one that is on disk
    assert tprobes.PROBES[tprobes.PORT_KERNELS] is None
    assert sorted(p.name for p in kernel_build.CSRC_DIR.glob("*.cu")) == sorted(
        kernel_build.SOURCES)


@pytest.mark.parametrize("name", KERNEL_PROBES)
def test_probe_twin_matches_numpy(name):
    probe = tprobes.PROBES[name]
    xs = probe.inputs(torch.Generator().manual_seed(tprobes.SEED))
    want = probe.reference(*[tprobes._to_numpy(x) for x in xs])
    got = probe.twin(*xs)
    got = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want.astype(got.dtype))


def test_tma_twin_zero_fills_outside_the_volume():
    probe = tprobes.PROBES["tma_load_5d"]
    (v,) = probe.inputs(torch.Generator().manual_seed(tprobes.SEED))
    box = probe.twin(v)
    assert box.shape == (2, 29, 29, 16)
    # box 0 starts at (-2, -2): its two first and last rows and cells are
    # the zero fill, its interior the plane
    assert not box[0, :2].any() and not box[0, :, :2].any()
    assert not box[0, 27:].any() and not box[0, :, 27:].any()
    assert torch.equal(box[0, 2:27, 2:27], v[2, 1])
    # box 1 runs past the far edges of plane (3, 4)
    assert not box[1, 25:].any() and not box[1, :, 24:].any()
    lanes = tprobes.PROBES["tma_load_848_lanes"]
    (x,) = lanes.inputs(torch.Generator().manual_seed(tprobes.SEED))
    assert not lanes.twin(x)[1, ..., 848 - 760:].any()


def test_battery_on_cpu_holds_twins_to_numpy(capsys):
    assert tprobes.main([], device="cpu") == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f"PASS {name}" for name in tprobes.PROBES]


def test_battery_reports_each_failed_build(monkeypatch, capsys):
    """A probe whose build fails is that probe's FAIL line (the first error
    line of its log), in the JAX tool's format; the run exits non-zero."""
    def broken(name, device=None):
        if name == "wgmma_m64n8k16_ss":
            return False, ("ptxas info: compiling\nptxas error   : "
                           "Instruction 'wgmma.mma_async' not supported\n")
        return True, ""

    monkeypatch.setattr(tprobes, "_compile", broken)
    names = ["ldmatrix_x4", "wgmma_m64n8k16_ss", "cluster_dsmem"]
    assert tprobes.main(names, device="cpu") == 1
    assert capsys.readouterr().out.splitlines() == [
        "PASS ldmatrix_x4",
        "FAIL wgmma_m64n8k16_ss: ptxas error   : Instruction "
        "'wgmma.mma_async' not supported",
        "PASS cluster_dsmem"]
    monkeypatch.setattr(tprobes, "_compile", lambda name, device=None: (False, ""))
    assert tprobes.run(["setmaxnreg"], device="cpu") == {
        "setmaxnreg": "FAIL: build failed"}


def test_battery_fails_a_probe_on_a_forbidden_build_warning(monkeypatch):
    log = ("ptxas warning : (C7508) Potential Performance Loss: setmaxnreg "
           "ignored; unable to determine register count at entry")
    monkeypatch.setattr(tprobes, "_compile", lambda name, device=None: (True, log))
    verdict = tprobes.run(["setmaxnreg", "ldmatrix_x4"], device="cpu")
    assert verdict["setmaxnreg"].startswith("FAIL: ptxas warning : (C7508)")
    assert verdict["ldmatrix_x4"] == "PASS"


def test_battery_names_unknown_probes():
    with pytest.raises(KeyError, match="unknown probes"):
        tprobes.run(["lane_merge"], device="cpu")


# ---------------------------------------------------------------------------
# the timing harness and the entry points
# ---------------------------------------------------------------------------


def test_timeit_differences_a_fake_clock(monkeypatch):
    """t(n) = 7 + 3 n ms: each length runs once as a warm-up, then reps
    pairs; the estimate is (t(n_long) - t(1)) / (n_long - 1) / per."""
    calls, seeds = [], []

    def fake_run_ms(step_fn, carry, n):
        calls.append(n)
        return 7.0 + 3.0 * n + (0.5 if len(calls) == 3 else 0.0)

    def make_input(g):
        seeds.append(g.initial_seed())
        return torch.zeros(2)

    monkeypatch.setattr(_timing, "_run_ms", fake_run_ms)
    ms = _timing.timeit(lambda c: c, make_input, n_long=6, reps=3, per=2,
                        device="cpu")
    assert calls == [1, 6, 1, 6, 1, 6, 1, 6]
    assert seeds == [0, 1, 100, 200, 101, 201, 102, 202]
    # the diffs are 2.9, 3, 3 (the first short run read 0.5 slow): median 3
    assert ms == pytest.approx(3.0 / 2)
    monkeypatch.setattr(_timing, "_run_ms", lambda f, c, n: 10.0 - n)
    assert _timing.timeit(lambda c: c, make_input, device="cpu") == 0.0


def test_entry_points_need_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("the refusal shows only where CUDA is not available")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tl2.main(["1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tl2.check()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tl2.make_mask()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tprobes.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tprobes.run(["ldmatrix_x4"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _timing.timeit(lambda c: c, lambda g: None)
    assert tprobes.run(["ldmatrix_x4"], device="cpu") == {"ldmatrix_x4": "PASS"}
