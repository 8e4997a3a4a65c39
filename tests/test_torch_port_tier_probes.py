"""The port's tier and stage probes (``ncnet_tpu_torch/tools/``) against
the JAX package's root tools, on the CPU at small shapes.

Timing never runs here: ``_timing.timeit`` is replaced by a stub that
fails if called, since on the CPU a probe runs each timed step once and
times nothing (``_probe.time_ms``).  What the probes compute is held
against the JAX package on the same numpy-seeded inputs and weights:

  * the kernel probes' parity (``nc_resident_probe``,
    ``nc_fused_lane_probe``: the resident stack and the per-layer chain;
    ``eval_faults_probe``: every tier) against the JAX Pallas kernels run
    with ``interpret=True`` and the JAX plain stack, normalized atol 3e-2
    (the NC stack suite's bf16 bound); ``nc_vjp_resident_probe``'s
    backward against the JAX kernel's VJP in interpret mode on the
    ReLU-margin stacks of ``tests/test_torch_port_nc_vjp.py``, the same
    3e-2 (the suite's k = 3 class);
  * the tier decisions: the chooser at the PF-Pascal 25⁴ stack, the
    sharded shapes' formulations;
  * ``sparse_corr_probe --tiny`` and ``cp_fft_probe --tiny``: the same
    parity numbers (1e-5), recall curve and gate verdicts as the root
    tools', on shared weights;
  * the formulation and gradient probes' own computations: ``abfold``
    against the root tool's (f32, 1e-5), the per-layer routed VJP against
    JAX's ``neigh_consensus(custom_grad=routing)`` (f32, 1e-4 of each
    gradient's largest value), the ablated losses against the root tools'
    (f32, rtol 1e-4), the InLoc stage shapes equal;
  * every probe runs its whole ``main`` on the CPU at shrunken module
    constants and exits 0, and refuses to run without a GPU unless the CPU
    is named.
"""

import importlib
import importlib.util
import json
import os
import re
import sys
import warnings

import numpy as np
import pytest
import torch

from torch_port_tool_twins import TOOLS, port_tool

NORM_ATOL = 3e-2

PROBES = ("nc_resident_probe", "nc_fused_lane_probe", "nc_vjp_resident_probe",
          "sparse_corr_probe", "eval_faults_probe", "train_probe",
          "inloc_stage_probe", "filter_stage_probe", "filter_combo_probe",
          "xla_layer_probe", "xla_conv_probe", "inloc_filter_probe",
          "sharded_variant_probe", "vjp_probe", "vjp_sweep_probe",
          "nc_grad_split_probe", "train_attr_probe", "cp_fft_probe")


@pytest.fixture(autouse=True)
def no_timing(monkeypatch):
    """Nothing is timed on the CPU."""
    from ncnet_tpu_torch.tools import _timing

    def timeit(*a, **k):
        raise AssertionError("a probe timed on the CPU")

    monkeypatch.setattr(_timing, "timeit", timeit)
    monkeypatch.setenv("NCNET_TPU_PERF_STORE", "off")
    monkeypatch.setenv("NCNET_TPU_MEMORY_LEDGER", "off")


def root_probe(name, argv, monkeypatch):
    """The root tool ``tools/<name>.py``, loaded afresh with ``argv`` (the
    root probes read ``sys.argv`` when imported) and kept out of
    ``sys.modules``: a root tool that binds ``sys.stdout.write`` when
    imported must not keep this test's capture for the JAX suite's tests
    of the same tool."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + list(argv))
    monkeypatch.syspath_prepend(TOOLS)
    spec = importlib.util.spec_from_file_location(
        f"root_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def assert_normalized_close(got, want, atol=NORM_ATOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1e-6, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


def seeded_stack(seed, kernels, channels, shape, x_scale=0.1):
    """numpy bf16-representable NC weights (normal: 0.05, biases 0.1) and an
    input volume, as the kernel probes draw them."""
    rng = np.random.default_rng(seed)
    layers, c_in = [], 1
    for k, c_out in zip(kernels, channels):
        layers.append({
            "w": rng.normal(0, 0.05, (k,) * 4 + (c_in, c_out)).astype(np.float32),
            "b": rng.normal(0, 0.1, (c_out,)).astype(np.float32)})
        c_in = c_out
    x = (rng.normal(0, 1, shape + (1,)) * x_scale).astype(np.float32)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    return ([{k: bf(v) for k, v in p.items()} for p in layers], bf(x),
            layers, x)


def jax_bf16(layers, x):
    import jax.numpy as jnp

    return ([{k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in p.items()}
             for p in layers], jnp.asarray(x).astype(jnp.bfloat16))


def jax_plain_stack(params, x):
    import jax

    from ncnet_tpu.ops.conv4d import conv4d

    for layer in params:
        x = jax.nn.relu(conv4d(x, layer["w"], layer["b"]))
    return x


# ---------------------------------------------------------------------------
# the kernel probes
# ---------------------------------------------------------------------------


SHAPE, KERNELS, CHANNELS = (1, 5, 5, 5, 5), (3, 3), (4, 1)


def test_stack_probes_match_the_jax_kernels(monkeypatch):
    """Both kernel stacks of ``nc_resident_probe.check`` (and
    ``nc_fused_lane_probe.check``'s) against the JAX Pallas kernels in
    interpret mode, and the plain stack against the JAX plain stack."""
    from ncnet_tpu.ops import nc_fused_lane as jlane

    params, x, layers, xn = seeded_stack(0, KERNELS, CHANNELS, SHAPE)
    jp, jx = jax_bf16(layers, xn)
    got = port_tool("nc_resident_probe").check(params, x)
    lane = port_tool("nc_fused_lane_probe").check(params, x)
    assert torch.equal(lane["fused_lane"], got["fused_lane"])
    want_res = jlane.nc_stack_resident(jp, jx, interpret=True)
    want_lane = jlane.nc_stack_fused_lane(jp, jx, interpret=True)
    want_plain = jax_plain_stack(jp, jx)
    assert_normalized_close(got["resident"].float(), want_res)
    assert_normalized_close(got["fused_lane"].float(), want_lane)
    assert_normalized_close(got["plain"].float(), want_plain)
    # the verdicts: each stack within the probes' 5 % of the plain stack
    want_rel = float(np.max(np.abs(np.asarray(want_res, np.float32)
                                   - np.asarray(want_plain, np.float32)))
                     ) / float(np.max(np.abs(np.asarray(want_plain,
                                                        np.float32))))
    assert (got["rel_resident"] < 0.05) == (want_rel < 0.05) == True  # noqa: E712


def test_chooser_decisions_match_jax():
    """The probes' tier decisions at the PF-Pascal 25⁴ stack and the
    kernels' gate's verdicts."""
    from ncnet_tpu.ops import nc_fused_lane as jlane

    verdict = port_tool("nc_resident_probe").shape_verdict()
    want = jlane.choose_fused_stack(25, 25, 25, 25, (5, 5, 5), (16, 16, 1))
    assert verdict == {"held": True, "chooser": want} and want == "fft"
    from ncnet_tpu_torch.ops import nc_fused_lane as tlane

    for arch in ("pf", "ivd"):
        kernels, channels = port_tool("nc_vjp_resident_probe").ARCHS[arch]
        assert tlane.kernels_hold(kernels, channels)
        # the arithmetic decisions agree; the JAX kernel tier needs a TPU,
        # the port's the kernels' gate (both archs are inside it)
        assert tlane.choose_fused_stack(
            25, 25, 25, 25, kernels, channels, pallas_ok=False) \
            == jlane.choose_fused_stack(25, 25, 25, 25, kernels, channels,
                                        pallas_ok=False)
        assert tlane.choose_fused_stack(25, 25, 25, 25, kernels, channels) \
            == {"pf": "fft", "ivd": "resident"}[arch]


def test_uncompiled_stack_is_refused(monkeypatch, capsys):
    tool = port_tool("nc_resident_probe")
    # k = 9: outside the kernels' gate
    monkeypatch.setattr(tool, "KERNELS", (9, 9))
    monkeypatch.setattr(tool, "CHANNELS", (7, 1))
    assert tool.main(["1", "--device", "cpu"]) == 1
    assert "NotImplementedError" in capsys.readouterr().out


def test_vjp_probe_matches_the_jax_kernel():
    """``nc_vjp_resident_probe.check``'s backward (the twin on the CPU)
    against the JAX kernel's VJP in interpret mode on a ReLU-margin
    stack; the kernel-vs-twin error is 0 on the CPU."""
    from ncnet_tpu.ops.nc_fused_lane_vjp import nc_stack_fused_vjp
    from test_torch_port_nc_vjp import SOUND, as_jax, as_torch, margin_stack

    shape, kernels, channels = SOUND[0]  # 2-layer k = 3, batch 2
    layers, x, g = margin_stack(1, shape, kernels, channels)
    d_params, dx = nc_stack_fused_vjp(*as_jax(layers, x, g), interpret=True)
    res = port_tool("nc_vjp_resident_probe").check(*as_torch(layers, x, g))
    assert res["rel_kernel"] == 0.0
    got_p, got_dx = res["kernel"]
    for a, b in zip(got_p, d_params):
        for k in ("w", "b"):
            assert_normalized_close(a[k].float(), np.asarray(b[k], np.float32))
    assert_normalized_close(got_dx.float(), np.asarray(dx, np.float32))


def test_eval_faults_tiers_match_jax_and_retry_on_the_same_tier():
    """Every tier ``eval_faults_probe`` runs against its JAX counterpart
    (the Pallas kernels in interpret mode, the FFT stack, the plain stack),
    then the injected failure's retry: the same tier, bit-equal."""
    from ncnet_tpu.ops import nc_fused_lane as jlane
    from ncnet_tpu.ops.conv4d_fft import nc_stack_fft

    tool = port_tool("eval_faults_probe")
    params, x, layers, xn = seeded_stack(2, KERNELS, CHANNELS, SHAPE)
    jp, jx = jax_bf16(layers, xn)
    res = tool.run_tiers(params, x)
    want = {"resident": jlane.nc_stack_resident(jp, jx, interpret=True),
            "fused_lane": jlane.nc_stack_fused_lane(jp, jx, interpret=True),
            "fft": nc_stack_fft(jp, jx), "xla": jax_plain_stack(jp, jx)}
    for tier, out in res["outputs"].items():
        assert_normalized_close(out, want[tier])
    assert all(e < tool.TOLERANCE for e in res["errors"].values())
    rc = tool.retry_check(params, x)
    assert rc["failure_kinds"] == ["device"]
    assert rc["start"] == rc["retry_tier"] == "resident"
    assert rc["bit_equal"]


# ---------------------------------------------------------------------------
# the tiny modes
# ---------------------------------------------------------------------------


def tiny_lines(text):
    return {ln.split(":")[0].strip(): ln for ln in text.splitlines()}


def numbers(line):
    return [float(v) for v in re.findall(
        r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?", line.split(":", 1)[1])]


def shared_params(monkeypatch, root, port, kernels, channels, nc_only):
    """Both tools' ``_params_for`` return the same weights."""
    import jax
    import jax.numpy as jnp

    params = port._params_for(kernels, channels)
    nc = params["nc"] if isinstance(params, dict) else params
    jnc = [{k: jnp.asarray(v.numpy()) for k, v in p.items()} for p in nc]
    monkeypatch.setattr(port, "_params_for",
                        lambda *a, **k: params)
    monkeypatch.setattr(root, "_params_for",
                        lambda *a, **k: jnc if nc_only else {"nc": jnc})
    del jax


def run_out(mod, argv, capsys):
    out = []
    saved = mod._out
    mod._out = out.append
    try:
        rc = mod.main(argv)
    finally:
        mod._out = saved
    return rc, "".join(out)


def test_sparse_corr_tiny_matches_the_root_tool(monkeypatch, capsys):
    root = root_probe("sparse_corr_probe", [], monkeypatch)
    port = port_tool("sparse_corr_probe")
    shared_params(monkeypatch, root, port, (3, 3), (4, 1), nc_only=False)
    # the root tool's last rung compiles the sparse program for its memory
    # analysis; on the CPU the port measures none, so neither side runs it
    monkeypatch.setattr(root, "_aot_memory", lambda *a: (None, None))
    rc_j, want = run_out(root, ["--tiny"], capsys)
    rc_t, got = run_out(port, ["--tiny", "--device", "cpu"], capsys)
    assert rc_j == rc_t == 0
    want, got = tiny_lines(want), tiny_lines(got)
    assert numbers(got["gather kernel vs plain tier"]) == \
        numbers(want["gather kernel (interpret) vs XLA tier"]) == [0.0]
    np.testing.assert_allclose(
        numbers(got["k=full sparse vs dense volume"]),
        numbers(want["k=full sparse vs dense volume"]), atol=1e-5)
    assert got["recall @ k=1,4,full"] == want["recall @ k=1,4,full"]
    assert got["tiny smoke"] == "tiny smoke: OK"


def test_cp_fft_tiny_matches_the_root_tool(monkeypatch, capsys):
    root = root_probe("cp_fft_probe", [], monkeypatch)
    port = port_tool("cp_fft_probe")
    # the root tool's memory row decomposes the 25⁴ stack and compiles its
    # programs; on the CPU the port measures none, so neither side runs it
    monkeypatch.setattr(root, "_aot_memory", lambda *a: (None, None))
    monkeypatch.setattr(importlib.import_module("ncnet_tpu.ops.cp_als"),
                        "decompose_stack", lambda p, *a, **k: (p, None))
    monkeypatch.setattr(root, "_params_for", lambda *a, **k: [])
    rc_j, want = run_out(root, ["--tiny"], capsys)
    rc_t, got = run_out(port, ["--tiny", "--device", "cpu"], capsys)
    assert rc_j == rc_t == 0
    want, got = tiny_lines(want), tiny_lines(got)
    for k in ("k=3 parity", "k=5 parity"):
        np.testing.assert_allclose(numbers(got[k])[1:], numbers(want[k])[1:],
                                   atol=1e-5)
        assert max(numbers(got[k])[1:]) < 1e-4
    gates = "gate direction (fft k5, !fft k3, cp r16, !cp rank-full)"
    assert got[gates] == want[gates]
    assert got["tiny smoke"] == "tiny smoke: OK"


# ---------------------------------------------------------------------------
# the formulation and gradient probes' computations
# ---------------------------------------------------------------------------


def test_abfold_matches_the_root_formulation(monkeypatch):
    import jax.numpy as jnp

    root = root_probe("filter_combo_probe", ["1"], monkeypatch)
    rng = np.random.default_rng(4)
    for k, c_in, c_out in ((3, 4, 3), (5, 2, 2)):
        x = rng.normal(size=(1, 5, 4, 6, 5, c_in)).astype(np.float32)
        w = rng.normal(size=(k,) * 4 + (c_in, c_out)).astype(np.float32)
        b = rng.normal(size=(c_out,)).astype(np.float32)
        want = np.asarray(root.conv4d_abfold(jnp.asarray(x), jnp.asarray(w),
                                             jnp.asarray(b)))
        got = port_tool("filter_combo_probe").conv4d_abfold(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert port_tool("filter_combo_probe").check_abfold(
        torch.device("cpu"), shape=(1, 5, 5, 5, 5), c_in=4, c_out=2) <= 1.0


def test_sharded_routing_matches_jax():
    import jax.numpy as jnp

    from ncnet_tpu.ops.conv4d import choose_conv4d_variant

    tool = port_tool("sharded_variant_probe")
    c, k = tool.C, tool.K
    want = (choose_conv4d_variant(
        1, 2 * c, tool.HB_LOC + 2 * tool.HALO, tool.WB,
        shape_a=(tool.HA, tool.WA), kernel=(k,) * 4, same_pad=False,
        dtype=jnp.bfloat16, batch=1),
        choose_conv4d_variant(
        c, 1, tool.HB_LOC, tool.WB, shape_a=(tool.HA, tool.WA),
        kernel=(k,) * 4, same_pad=False, dtype=jnp.bfloat16, batch=1))
    assert tool.auto_routing() == want


def test_inloc_stage_shapes_match_the_root_tool(monkeypatch):
    root = root_probe("inloc_stage_probe", [], monkeypatch)
    q, d, fq, fd, pq, pd = port_tool("inloc_stage_probe").shapes()
    assert (q, d) == ((root.QH, root.QW), (root.DH, root.DW))
    assert (fq, fd, pq, pd) == (root.FQ, root.FD, root.PQ, root.PD)
    inloc_filter = port_tool("inloc_filter_probe")
    assert (inloc_filter.FQ, inloc_filter.FD, inloc_filter.PQ,
            inloc_filter.PD) == (fq, fd, pq, pd)


def jax_stack_params(seed, n_ch=(2, 2, 1), k=3):
    """f32 NC weights as numpy (port and JAX layouts agree)."""
    rng = np.random.default_rng(seed)
    out, c_in = [], 1
    for c_out in n_ch:
        out.append({"w": rng.normal(0, 0.2, (k,) * 4 + (c_in, c_out)
                                    ).astype(np.float32),
                    "b": rng.normal(0, 0.1, (c_out,)).astype(np.float32)})
        c_in = c_out
    return out


def test_routed_vjp_matches_jax_custom_grad():
    """``vjp_sweep_probe.routed_consensus`` gradients (params and volume)
    against JAX's ``neigh_consensus(custom_grad=routing)`` in f32."""
    import jax
    import jax.numpy as jnp

    from ncnet_tpu.models.ncnet import neigh_consensus

    tool = port_tool("vjp_sweep_probe")
    layers = jax_stack_params(5)
    corr = np.random.default_rng(6).normal(
        0, 1, (1, 4, 4, 4, 4)).astype(np.float32)
    routing = tool.parse_spec("unroll/coutfold,-,auto/tapfold")

    def jloss(p, c):
        return jnp.mean(neigh_consensus(p, c, symmetric=True,
                                        custom_grad=routing))

    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in layers]
    want_p, want_c = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(corr))
    tp = [{k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
          for p in layers]
    tc = torch.from_numpy(corr).requires_grad_()
    tool.routed_consensus(tp, tc, routing).mean().backward()
    for a, b in zip(tp, want_p):
        for k in ("w", "b"):
            assert_normalized_close(a[k].grad, b[k], atol=1e-4)
    assert_normalized_close(tc.grad, want_c, atol=1e-4)


@pytest.mark.parametrize("name,variant,fold", [
    ("train_attr_probe", "full", False), ("train_attr_probe", "no_mm", True),
    ("nc_grad_split_probe", None, False)])
def test_probe_losses_match_the_root_tools(name, variant, fold, monkeypatch):
    """The ablated losses of ``train_attr_probe`` and the stack loss of
    ``nc_grad_split_probe`` on the same features and weights, f32."""
    import jax.numpy as jnp

    root = root_probe(name, ["2", "f32", "y" if fold else "n"], monkeypatch)
    rng = np.random.default_rng(8)
    fa, fb = (rng.normal(size=(2, 4, 4, 8)).astype(np.float32)
              for _ in range(2))
    fa /= np.linalg.norm(fa, axis=-1, keepdims=True)
    fb /= np.linalg.norm(fb, axis=-1, keepdims=True)
    layers = jax_stack_params(9)
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in layers]
    tp = [{k: torch.from_numpy(v) for k, v in p.items()} for p in layers]
    port = port_tool(name)
    if name == "train_attr_probe":
        want = float(root.make_loss(variant)(jp, jnp.asarray(fa),
                                             jnp.asarray(fb)))
        got = float(port.make_loss(variant, torch.float32, fold)(
            tp, torch.from_numpy(fa), torch.from_numpy(fb)))
    else:
        from ncnet_tpu.ops import correlation_4d
        from ncnet_tpu_torch.ops.correlation import correlation_4d as tcorr

        want = float(root.stack_loss(jp, correlation_4d(
            jnp.asarray(fa), jnp.asarray(fb))))
        got = float(port.stack_loss(tp, tcorr(torch.from_numpy(fa),
                                              torch.from_numpy(fb)),
                                    torch.float32))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)


# ---------------------------------------------------------------------------
# every probe's main on the CPU, and the refusal
# ---------------------------------------------------------------------------


def timings(doc, timed=False):
    """Every value under a key that names milliseconds."""
    if isinstance(doc, dict):
        return [v for k, x in doc.items()
                for v in timings(x, timed or "ms" in str(k))]
    return [doc] if timed else []


SMALL = {
    "nc_resident_probe": (dict(S=5, KERNELS=(3, 3), CHANNELS=(4, 1)), ["1"]),
    "nc_fused_lane_probe": (dict(S=5, KERNELS=(3, 3), CHANNELS=(4, 1)), ["1"]),
    "nc_vjp_resident_probe": (dict(S=4, ARCHS={"ivd": ((3, 3), (16, 1))}),
                              ["1", "ivd"]),
    "sparse_corr_probe": ({}, ["--k", "1,2", "--size", "8", "--c", "16",
                               "--kernels", "3,3", "--channels", "4,1",
                               "--time"]),
    "eval_faults_probe": (dict(KERNELS=(3, 3), CHANNELS=(4, 1)), ["5"]),
    "train_probe": (dict(SIZE=64, BACKBONE="tiny"),
                    ["2", "bf16", "base=n,y,n,n", "fold=y,y,n,n"]),
    "inloc_stage_probe": (dict(QUERY_HW=(160, 120), DB_HW=(120, 160),
                               IMAGE_SIZE=128, BACKBONE="tiny", FEAT_C=32),
                          []),
    "filter_stage_probe": (dict(IMG_FEAT=5, FEAT_C=8), ["1"]),
    "filter_combo_probe": ({}, ["1"]),
    "xla_layer_probe": (dict(S=4), ["1"]),
    "xla_conv_probe": (dict(S=4), ["1"]),
    "inloc_filter_probe": (dict(FQ=(8, 6), FD=(6, 8), PQ=(4, 3), PD=(3, 4)),
                           []),
    "sharded_variant_probe": (dict(HA=5, WA=4, HB_LOC=3, WB=4), []),
    # the sweeps cut to two of their rows each
    "vjp_probe": (dict(S=4, CONFIGS=[("plain_ad", None),
                                     ("dw_coutfold", "coutfold")]), ["1"]),
    "vjp_sweep_probe": (dict(S=4, C=8, DEFAULT_SWEEP=[
        ("plain", None), ("custom_def", [{"dx": "auto", "dw": "coutfold"}] * 3)]),
        ["1"]),
    "nc_grad_split_probe": (dict(S=4, C=8, VARIANTS=("nc_fwd", "nc_both")),
                            ["1", "bf16"]),
    "train_attr_probe": (dict(S=4, C=8, VARIANTS=("full", "nc_only")),
                         ["2", "bf16", "y"]),
    "cp_fft_probe": ({}, ["--ranks", "2", "--size", "5", "--kernels", "3,3",
                          "--channels", "4,1", "--iters", "2", "--time"]),
}


@pytest.mark.parametrize("name", PROBES)
def test_probe_main_runs_on_the_cpu(name, monkeypatch, capsys):
    """The whole ``main`` at shrunken constants: exit 0, nothing timed,
    every timing and memory row reported as not measured."""
    consts, argv = SMALL[name]
    tool = port_tool(name)
    for k, v in consts.items():
        monkeypatch.setattr(tool, k, v)
    if name == "filter_combo_probe":
        stage = port_tool("filter_stage_probe")
        monkeypatch.setattr(stage, "IMG_FEAT", 5)
        monkeypatch.setattr(stage, "FEAT_C", 8)
    if hasattr(tool, "_out"):
        out = []
        monkeypatch.setattr(tool, "_out", out.append)
        assert tool.main(argv + ["--device", "cpu"]) == 0
        doc = json.loads("".join(out))
    else:
        assert tool.main(argv + ["--device", "cpu"]) == 0
        text = capsys.readouterr().out
        line = [ln for ln in text.splitlines() if ln.startswith("summary ")]
        doc = json.loads(line[-1][len("summary "):])
    assert all(v is None for v in timings(doc))
    assert timings(doc) or name == "eval_faults_probe"  # it times nothing
    assert "FAILED" not in json.dumps(doc) and "ERR" not in json.dumps(doc)


@pytest.mark.parametrize("name", PROBES)
def test_probes_need_cuda_unless_told_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("the refusal shows only where CUDA is not available")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_tool(name).main([])
