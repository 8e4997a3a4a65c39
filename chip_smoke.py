#!/usr/bin/env python3
"""Drive the PyTorch port (``ncnet_tpu_torch``) on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure (nothing is caught):

  1. the card's name and power limit (``nvidia-smi``); TF32 off for
     float32 matmuls and convolutions, so the plain versions are full f32;
  2. build every CUDA kernel from ``ncnet_tpu_torch/csrc`` with ``nvcc`` for
     ``sm_90a`` (one ``nvcc`` per source, all in parallel);
  3. every kernel against its plain PyTorch version on the card, in bf16,
     at the shape the serving and training paths give it and at the thin
     test shapes, with CUDA-event times of both: the NC stack (B2) and its
     backward (B3: dW/db partials, their reduction, the transposed conv),
     the backward on the same saved activations as its twin;
  4. the serving path at full width: ``BatchMatchEngine`` with the
     PF-Pascal NCNet (ResNet-101 to layer3, NC kernels (5, 5, 5) with
     channels (16, 16, 1), bf16, 400×400 pairs, random weights from a
     seed) answers 3 requests of 4 pairs; the kernel launch counter,
     reset just before, proves the path went through the kernel; one
     request runs again, and the kernel is held against its plain version
     on the exact volume the path hands it, and the filtered volume
     against the same forward with the plain NC stack;
  5. the training path at full width: ``create_train_state`` and
     ``make_train_step`` with the published PF-Pascal recipe (batch 16 of
     400² pairs, lr 5e-4, bf16 NC stack, fp32 frozen trunk, automatic
     volume chunks, NaN guard; random weights from a seed, the trunk's
     BatchNorm statistics set from one seeded batch, NC kernels
     centre-peaked with biases off zero; each target its source shifted
     by whole feature cells) take a warm-up step and 3 timed steps; the
     launch counters, reset just before, must read the per-step formula;
     on the last chunk's exact volume and cotangent the backward kernels
     are held against their twin, and the step's loss and NC gradients
     against the same step with the twins routed in for both directions;
     a stage line splits a step's time;
  6. a ``kernels`` JSON line, then the last line
     ``{"ok": true, "device": {...}}``.

Without CUDA, or without the package beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

# published dense peaks of one H100 SXM (NVIDIA data sheet) at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12
TOLERANCE = 1e-2          # max|kernel − plain| / max|plain|, bf16 outputs
# The filtered volume of the whole forward, kernel path vs plain path.  The
# two stacks sum in different orders, so a few bf16 outputs round one ulp
# apart (at most 2^-7 of the value: bf16 keeps 7 mantissa bits).  The
# bf16 symmetric sum and the final bf16 mutual matching x·(x/maxA)·(x/maxB)
# cube that relative change and add four roundings: up to ~7 ulps of a
# near-maximal cell.  The kernel itself is held to TOLERANCE on the exact
# volume the path hands it.
SERVE_TOLERANCE = 7 * 2.0 ** -7

# (name, volume shape (B, hA, wA, hB, wB), kernel sizes, channels)
STACK_SHAPES = (
    # the serving path's call: 4 pairs, batch-folded with their transposes
    ("pf_pascal_25^4_B8", (8, 25, 25, 25, 25), (5, 5, 5), (16, 16, 1)),
    ("rectangular_3layer", (1, 6, 5, 7, 6), (3, 3, 3), (4, 4, 1)),
    ("two_channel_final", (2, 6, 7, 5, 8), (3, 3), (4, 2)),
    ("k3_single_layer", (1, 7, 7, 7, 7), (3,), (1,)),
)
SERVE_BATCH, SERVE_REQUESTS, SERVE_SIDE = 4, 3, 400
TRAIN_STEPS = 3
# each training target is its source rolled by whole feature cells (16 px)
TRAIN_SHIFT = (32, 48)
# The training step, kernels vs twins in both directions (phase 5): the
# relative L2 distance of the step's NC gradients.  The kernels' step is the
# twins' arithmetic with the f32 sums in another order, so a bf16 activation
# or gradient here and there rounds one ulp (2^-8 relative) apart; a
# control step, the twins with the sums reordered, shows that spread on the
# spot.  A wrong sign, scale or a missing chunk moves the gradients by
# their own size.
STEP_TOLERANCE = 1e-2


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` warm calls, timed with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def stack_params(kernels, channels, seed: int, device):
    """Random NC stack (normal, 0.1 scale, the JAX kernel tests' recipe)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    params, c_in = [], 1
    for k, c_out in zip(kernels, channels):
        w = torch.randn((k,) * 4 + (c_in, c_out), generator=g) * 0.1
        b = torch.randn((c_out,), generator=g) * 0.1
        params.append({"w": w.to(device, torch.bfloat16),
                       "b": b.to(device, torch.bfloat16)})
        c_in = c_out
    return params


def stack_work(shape, kernels, channels, c_in=1, backward=False,
               need_dx=False):
    """(FLOP, bytes) a stack of layers on a ``c_in``-channel volume needs:
    multiply-adds only at taps inside the volume (same padding), each
    input, weight and output byte once (bf16).

    ``backward``: the stack's backward from its saved activations instead:
    per layer dW (the forward's count of multiply-adds) and the input
    gradient (the same count again), which layer 0 needs only with
    ``need_dx``; it reads every saved activation, the cotangent and the
    weights once and writes dW, db (and ``dx``) once."""
    b, *dims = shape
    cells = _prod(dims)
    flops, nbytes = 0, 2 * b * cells * c_in
    for li, (k, c_out) in enumerate(zip(kernels, channels)):
        d = k // 2
        taps = _prod(sum(min(n - 1, x + d) - max(0, x - d) + 1
                         for x in range(n)) for n in dims)
        layer = 2 * b * taps * c_in * c_out
        if backward:
            flops += layer * (2 if li > 0 or need_dx else 1)
            nbytes += 2 * 2 * (k ** 4 * c_in * c_out + c_out)
            nbytes += 2 * b * cells * c_out  # the saved output
        else:
            flops += layer
            nbytes += 2 * (k ** 4 * c_in * c_out + c_out)
        c_in = c_out
    nbytes += 2 * b * cells * channels[-1]  # the output, or the cotangent
    if backward and need_dx:
        nbytes += 2 * b * cells
    return flops, nbytes


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def normalized_err(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-12))


@contextlib.contextmanager
def routed_nc_stack(stack_fn, calls=None):
    """Route the model's NC stack through ``stack_fn`` and record each
    call's ``(input, output)`` in ``calls`` (the comparison runs of phase
    4; the port itself never routes its stack anywhere but the kernel)."""
    from ncnet_tpu_torch.ops import nc_fused_lane

    real = nc_fused_lane.nc_stack_resident

    def routed(params, x):
        y = stack_fn(params, x)
        if calls is not None:
            calls.append((params, x, y))
        return y

    nc_fused_lane.nc_stack_resident = routed
    try:
        yield
    finally:
        nc_fused_lane.nc_stack_resident = real


def check_kernels(torch, nc_fused_lane, dev):
    """Phase 3: kernel vs plain twin at every shape; returns the main-path
    shape's numbers."""
    main = None
    for name, shape, kernels, channels in STACK_SHAPES:
        params = stack_params(kernels, channels, seed=1, device=dev)
        g = torch.Generator().manual_seed(2)
        x = (torch.randn(shape + (1,), generator=g) * 0.5).to(dev, torch.bfloat16)
        got = nc_fused_lane.nc_stack_resident(params, x)
        want = nc_fused_lane.nc_stack_reference(params, x)
        torch.cuda.synchronize()
        err = normalized_err(got, want)
        max_abs = float((got.float() - want.float()).abs().max())
        print(f"check {name}: shape {shape} kernels {kernels} channels "
              f"{channels} max_abs_err {max_abs:.6g} normalized {err:.3e} "
              f"(tolerance {TOLERANCE})", flush=True)
        if not (err <= TOLERANCE and torch.isfinite(got.float()).all()):
            raise SystemExit(f"kernel disagrees with its plain twin at {name}")
        if main is None:
            iters = 5
            # in turns: kernel, plain, kernel, plain
            ms_k = [cuda_ms(lambda: nc_fused_lane.nc_stack_resident(params, x), iters)]
            ms_p = [cuda_ms(lambda: nc_fused_lane.nc_stack_reference(params, x), iters)]
            ms_k.append(cuda_ms(lambda: nc_fused_lane.nc_stack_resident(params, x), iters))
            ms_p.append(cuda_ms(lambda: nc_fused_lane.nc_stack_reference(params, x), iters))
            v = x
            for li, layer in enumerate(params):
                layer_ms = cuda_ms(lambda: nc_fused_lane.nc_conv4d_layer(
                    v, layer["w"], layer["b"]), iters)
                f, _ = stack_work(shape, kernels[li:li + 1],
                                  channels[li:li + 1], c_in=int(v.shape[-1]))
                print(f"layer {li} {tuple(layer['w'].shape)}: {layer_ms:.3f} ms, "
                      f"{f / layer_ms / 1e9:.2f} TFLOP/s", flush=True)
                v = nc_fused_lane.nc_conv4d_layer(v, layer["w"], layer["b"])
            flops, nbytes = stack_work(shape, kernels, channels)
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S
            main = {
                "max_abs_err": max_abs, "normalized_err": err,
                "ms": sum(ms_k) / 2, "plain_ms": sum(ms_p) / 2,
                "bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            }
            print(f"timing {name}: kernel {ms_k} ms, plain {ms_p} ms, "
                  f"{flops:.4g} FLOP, {nbytes:.4g} bytes", flush=True)
    return main


def grads_err(got, want):
    """(largest normalized error, largest absolute error) over the
    gradient tensors of two ``(d_params, dx)`` results."""
    (dp_a, dx_a), (dp_b, dx_b) = got, want
    pairs = [(a[k], b[k]) for a, b in zip(dp_a, dp_b) for k in ("w", "b")]
    if dx_b is not None:
        pairs.append((dx_a, dx_b))
    return (max(normalized_err(a, b) for a, b in pairs),
            max(float((a.float() - b.float()).abs().max()) for a, b in pairs))


def check_backward(torch, nc_fused_lane, vjp, dev):
    """Phase 3, B3: the backward kernels against the twin on the same saved
    activations (so the ReLU masks are the same cells), ``dx`` included,
    at every shape; two kernel runs bit-identical.  Returns the training
    shape's numbers, timed as the training path runs it (no ``dx``)."""
    main = None
    for name, shape, kernels, channels in STACK_SHAPES:
        params = stack_params(kernels, channels, seed=3, device=dev)
        g = torch.Generator().manual_seed(4)
        x = (torch.randn(shape + (1,), generator=g) * 0.5).to(dev, torch.bfloat16)
        acts = nc_fused_lane.stack_activations(params, x)
        cot = (torch.randn(tuple(acts[-1].shape), generator=g) * 0.5
               ).to(dev, torch.bfloat16)
        got = vjp.stack_vjp(params, acts, cot)
        again = vjp.stack_vjp(params, acts, cot)
        want = vjp.stack_vjp(params, acts, cot, twin=True)
        torch.cuda.synchronize()
        err, max_abs = grads_err(got, want)
        same = grads_err(got, again)[1] == 0.0
        finite = all(torch.isfinite(t.float()).all() for d in got[0]
                     for t in d.values()) and torch.isfinite(got[1].float()).all()
        print(f"check backward {name}: dW, db, dx max_abs_err {max_abs:.6g} "
              f"normalized {err:.3e} (tolerance {TOLERANCE}); two runs "
              f"bit-identical: {same}", flush=True)
        if not (err <= TOLERANCE and same and finite):
            raise SystemExit(f"the backward kernels disagree with the twin at {name}")
        if main is None:
            iters = 3
            run_k = lambda: vjp.stack_vjp(params, acts, cot, need_dx=False)  # noqa: E731
            run_p = lambda: vjp.stack_vjp(params, acts, cot, need_dx=False,  # noqa: E731
                                          twin=True)
            ms_k, ms_p = [cuda_ms(run_k, iters)], [cuda_ms(run_p, iters)]
            ms_k.append(cuda_ms(run_k, iters))
            ms_p.append(cuda_ms(run_p, iters))
            gamma = cot
            for li in reversed(range(len(params))):
                w, k = params[li]["w"], int(params[li]["w"].shape[0])
                gz, part = vjp.nc_vjp_dw(acts[li], acts[li + 1], gamma, k)
                dw_ms = cuda_ms(lambda: vjp.nc_vjp_dw(
                    acts[li], acts[li + 1], gamma, k), iters)
                red_ms = cuda_ms(lambda: vjp.nc_vjp_reduce(part), iters)
                line = (f"backward layer {li} {tuple(w.shape)}: dW/db "
                        f"{dw_ms:.3f} ms, reduce {red_ms:.3f} ms")
                if li > 0:
                    t_ms = cuda_ms(lambda: vjp.nc_conv4d_transpose(gz, w), iters)
                    line += f", transposed conv {t_ms:.3f} ms"
                    gamma = vjp.nc_conv4d_transpose(gz, w)
                print(line, flush=True)
            flops, nbytes = stack_work(shape, kernels, channels, backward=True)
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S
            main = {
                "max_abs_err": max_abs, "normalized_err": err,
                "ms": sum(ms_k) / 2, "plain_ms": sum(ms_p) / 2,
                "bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            }
            print(f"timing backward {name} (no dx): kernels {ms_k} ms, plain "
                  f"{ms_p} ms, {flops:.4g} FLOP, {nbytes:.4g} bytes, "
                  f"{flops / main['ms'] / 1e9:.2f} TFLOP/s", flush=True)
    return main


def serve(torch, nc_fused_lane, dev):
    """Phase 4: the full-width bf16 serving path through BatchMatchEngine."""
    import numpy as np

    from ncnet_tpu_torch.config import ModelConfig
    from ncnet_tpu_torch.models.ncnet import init_ncnet, ncnet_forward
    from ncnet_tpu_torch.ops.image import normalize_imagenet
    from ncnet_tpu_torch.serving.engine import BatchMatchEngine

    cfg = ModelConfig(backbone="resnet101", ncons_kernel_sizes=(5, 5, 5),
                      ncons_channels=(16, 16, 1), half_precision=True,
                      backbone_bf16=True)
    engine = BatchMatchEngine(cfg, init_ncnet(cfg, seed=0))
    rng = np.random.default_rng(0)
    shape = (SERVE_BATCH, SERVE_SIDE, SERVE_SIDE, 3)
    requests = [(rng.integers(0, 256, shape, dtype=np.uint8),
                 rng.integers(0, 256, shape, dtype=np.uint8))
                for _ in range(SERVE_REQUESTS + 1)]
    n_cells = (SERVE_SIDE // 16) ** 2

    engine.fetch(engine.dispatch(*requests[-1]))  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nc_fused_lane.launches = 0
    walls, tables = [], []
    for src, tgt in requests[:SERVE_REQUESTS]:
        t0 = time.perf_counter()
        tables.append(engine.fetch(engine.dispatch(src, tgt)))
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = nc_fused_lane.launches
    peak = torch.cuda.max_memory_allocated()
    print(f"serve: {SERVE_REQUESTS} requests of {SERVE_BATCH} pairs at "
          f"{SERVE_SIDE}x{SERVE_SIDE}, wall ms per request {walls}, peak "
          f"memory {peak} bytes, kernel launches {launches}", flush=True)
    for table in tables:
        matches, quality = engine.split(table)
        if table.shape != (SERVE_BATCH, 6, n_cells) or not np.isfinite(table).all():
            raise SystemExit(f"bad table {table.shape}")
        score = matches[:, 4]
        if score.min() < 0 or score.max() > 1:
            raise SystemExit("scores outside [0, 1]")
        for q in quality:
            if not all(0.0 <= v <= 1.0 for v in q.values()):
                raise SystemExit(f"quality signals outside [0, 1]: {q}")
    if launches != 3 * SERVE_REQUESTS:
        raise SystemExit(f"expected {3 * SERVE_REQUESTS} kernel launches, "
                         f"counted {launches}")
    print(f"serve: tables ok; quality of pair 0: {quality[0]}", flush=True)

    # one request again, its NC stack through the kernel and then through
    # the plain twin: the kernel on the exact volume the path hands it, and
    # the filtered volume that comes out of each
    src, tgt = (normalize_imagenet(torch.as_tensor(a).to(dev))
                for a in requests[0])
    calls = []
    with torch.no_grad():
        with routed_nc_stack(nc_fused_lane.nc_stack_resident, calls):
            got = ncnet_forward(cfg, engine._params, src, tgt).corr
        with routed_nc_stack(nc_fused_lane.nc_stack_reference):
            want = ncnet_forward(cfg, engine._params, src, tgt).corr
        (params, x, y_kernel), = calls
        y_plain = nc_fused_lane.nc_stack_reference(params, x)
    torch.cuda.synchronize()
    err = normalized_err(y_kernel, y_plain)
    print(f"serve: NC stack on the served volume {tuple(x.shape)}: kernel vs "
          f"plain normalized error {err:.3e} (tolerance {TOLERANCE}), "
          f"{float((y_kernel != y_plain).float().mean()):.3e} of the cells "
          "differ", flush=True)
    if not err <= TOLERANCE:
        raise SystemExit("the kernel disagrees with its plain twin on the "
                         "served volume")
    err = normalized_err(got, want)
    print(f"serve: filtered volume {tuple(got.shape)} kernel path vs plain "
          f"path normalized error {err:.3e} (tolerance {SERVE_TOLERANCE})",
          flush=True)
    if not err <= SERVE_TOLERANCE:
        raise SystemExit("the served volume disagrees with the plain path")
    stage_breakdown(torch, nc_fused_lane, cfg, engine._params, src, tgt, x)
    return launches


def stage_breakdown(torch, nc_fused_lane, cfg, params, src, tgt, nc_input):
    """CUDA-event ms of each stage of one request's forward (warm, one
    stage at a time, so the sum is an upper bound on the device time)."""
    from ncnet_tpu_torch.models.ncnet import extract_features, ncnet_filter
    from ncnet_tpu_torch.observability.quality import append_quality_rows
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.matching import corr_to_matches

    nc_bf16 = [{k: v.to(torch.bfloat16) for k, v in layer.items()}
               for layer in params["nc"]]

    def trunk():
        return (extract_features(cfg, params, src),
                extract_features(cfg, params, tgt))

    def tables(corr):
        m = corr_to_matches(corr, do_softmax=True)
        return append_quality_rows(
            torch.stack([v.to(torch.float32) for v in m], dim=1), corr)

    with torch.no_grad():
        fa, fb = (f.to(torch.bfloat16) for f in trunk())
        corr = correlation_4d(fa, fb)
        filtered = ncnet_filter(cfg, params, corr).corr
        stages = {
            "trunk, both sides": cuda_ms(trunk, 3),
            "correlation": cuda_ms(lambda: correlation_4d(fa, fb), 3),
            "filter (mutual, NC stack, mutual)": cuda_ms(
                lambda: ncnet_filter(cfg, params, corr), 3),
            "of which the NC stack kernel": cuda_ms(
                lambda: nc_fused_lane.nc_stack_resident(nc_bf16, nc_input), 3),
            "matches and quality row": cuda_ms(lambda: tables(filtered), 3),
        }
    print("serve stages ms per request: " + json.dumps(stages), flush=True)


@contextlib.contextmanager
def routed_fused_stack(stack_fn, calls=None):
    """Route the training path's differentiable NC stack through
    ``stack_fn`` and record each call's ``(params, input, output,
    cotangent)`` in ``calls`` (the comparison runs of phase 5)."""
    from ncnet_tpu_torch.ops import nc_fused_lane

    real = nc_fused_lane.nc_stack_fused

    def routed(params, x):
        y = stack_fn(params, x)
        if calls is not None:
            record = [params, x, y, None]
            calls.append(record)
            y.register_hook(lambda g: record.__setitem__(3, g))
        return y

    nc_fused_lane.nc_stack_fused = routed
    try:
        yield
    finally:
        nc_fused_lane.nc_stack_fused = real


def reordered_layer(perm):
    """The forward twin of one layer on the volume with its four cell dims
    permuted by ``perm`` (the taps to match): the same arithmetic, its f32
    sums in another order (the twin loops over the first dim's taps)."""
    from ncnet_tpu_torch.ops import nc_fused_lane

    to = (0, *(1 + p for p in perm), 5)
    back = tuple(to.index(i) for i in range(6))

    def layer(x, w, b):
        y = nc_fused_lane.layer_reference(
            x.permute(to), w.permute(*perm, 4, 5), b)
        return y.permute(back).contiguous()

    return layer


def twin_stack_fused(params, x, layer=None):
    """The differentiable stack with the twins in both directions: the
    forward twin layer by layer (``layer``, default ``layer_reference``),
    the backward twin on its activations."""
    import torch

    from ncnet_tpu_torch.ops import nc_fused_lane, nc_fused_lane_vjp

    layer = layer or nc_fused_lane.layer_reference

    class TwinStack(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, *flat):
            ps = [{"w": flat[i], "b": flat[i + 1]} for i in range(0, len(flat), 2)]
            acts = [x]
            for p in ps:
                acts.append(layer(acts[-1], p["w"], p["b"]))
            ctx.save_for_backward(*acts, *flat)
            ctx.n = len(ps)
            return acts[-1]

        @staticmethod
        def backward(ctx, g):
            saved = ctx.saved_tensors
            acts, flat = saved[:ctx.n + 1], saved[ctx.n + 1:]
            ps = [{"w": flat[i], "b": flat[i + 1]} for i in range(0, len(flat), 2)]
            d, dx = nc_fused_lane_vjp.stack_vjp(
                ps, acts, g, need_dx=ctx.needs_input_grad[0], twin=True)
            return (dx, *(t for layer in d for t in (layer["w"], layer["b"])))

    return TwinStack.apply(x, *(t for p in params for t in (p["w"], p["b"])))


def pair_scores(mc, params, batch, chunks):
    """The 2B bf16 pair scores of the step's loss (positives, then the
    rolled negatives), through the kernels, ``chunks`` stack calls."""
    import torch

    from ncnet_tpu_torch.models.ncnet import extract_features, ncnet_filter
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.training import match_score_per_pair

    fa, fb = (extract_features(mc, params, batch[k]).to(torch.bfloat16)
              for k in ("source_image", "target_image"))
    fa2 = torch.cat([fa, torch.roll(fa, -1, dims=0)])
    fb2 = torch.cat([fb, fb])
    c = fa2.shape[0] // chunks
    return torch.cat([match_score_per_pair(ncnet_filter(
        mc, params, correlation_4d(fa2[i:i + c], fb2[i:i + c])).corr)
        for i in range(0, fa2.shape[0], c)])


def step_check(loss_k, grads_k, loss_t, grads_t, control, scores):
    """The step's loss and NC gradients, kernels vs twins (see
    STEP_TOLERANCE); ``control`` is the reordered twins' step."""
    import torch

    def flat(grads):
        return torch.cat([t.float().flatten() for layer in grads["nc"]
                          for t in (layer["w"], layer["b"])])

    def rel_l2(grads):
        ref = flat(grads_t)
        return float((flat(grads) - ref).norm() / ref.norm().clamp_min(1e-30))

    g_err, g_ctrl = rel_l2(grads_k), rel_l2(control[1])
    l_err = abs(float(loss_k) - float(loss_t))
    l_ctrl = abs(float(control[0]) - float(loss_t))
    # each pair score is bf16 (one ulp is at most 2^-7 of it) and the loss
    # weights 2B of them by 1/B: one ulp of every score moves it by at most
    # 2 * 2^-7 of the largest score
    s_max = float(scores.float().abs().max())
    l_tol = 2 * 2.0 ** -7 * s_max
    print(f"train: step loss kernels {float(loss_k):.9g} vs twins "
          f"{float(loss_t):.9g}: |diff| {l_err:.3e}, control {l_ctrl:.3e}, "
          f"pair scores: positives mean {float(scores[:len(scores) // 2].float().mean()):.6g}, "
          f"negatives mean {float(scores[len(scores) // 2:].float().mean()):.6g}, "
          f"largest {s_max:.6g}, tolerance {l_tol:.3e}; NC gradients "
          f"relative L2 error {g_err:.3e}, control {g_ctrl:.3e}, tolerance "
          f"{STEP_TOLERANCE}", flush=True)
    if not (l_err <= l_tol and g_err <= STEP_TOLERANCE):
        raise SystemExit("the training step disagrees with the twins' step")


def calibrate_trunk(mc, params, images) -> None:
    """Set every BatchNorm of the frozen trunk to the statistics of its
    input on ``images``, layer after layer in one pass (a data-dependent
    init; a trained trunk's running statistics are its data's).  With the
    raw init (mean 0, variance 1) a random ResNet-101's layer3 features are
    near-parallel from cell to cell (``feature_contrast``), every bf16 pair
    score rounds to the same value, and the loss and its gradient are
    rounding noise."""
    import torch

    from ncnet_tpu_torch.models import backbone
    from ncnet_tpu_torch.models.ncnet import extract_features

    real = backbone._bn

    def bn(x, p):
        p["mean"] = x.mean(dim=(0, 2, 3))
        p["var"] = x.var(dim=(0, 2, 3), unbiased=False)
        return real(x, p)

    backbone._bn = bn
    try:
        with torch.no_grad():
            extract_features(mc, params, images)
    finally:
        backbone._bn = real


def feature_contrast(mc, params, batch):
    """(mean, mean of the row maxima) of the cosine between a source cell's
    trunk feature and every target cell's of its pair."""
    import torch

    from ncnet_tpu_torch.models.ncnet import extract_features

    with torch.no_grad():
        fa, fb = (torch.nn.functional.normalize(extract_features(
            mc, params, batch[k]).flatten(1, 2).float(), dim=-1)
            for k in ("source_image", "target_image"))
        cos = torch.bmm(fa, fb.transpose(1, 2))
    return float(cos.mean()), float(cos.amax(dim=2).mean())


def train(torch, nc_fused_lane, vjp, dev, model=None, **train_kw):
    """Phase 5: the full-width bf16 training step (``model`` and
    ``train_kw`` override the recipe, for a rehearsal at a small size)."""
    import numpy as np

    from ncnet_tpu_torch.config import ModelConfig, TrainConfig
    from ncnet_tpu_torch.ops.image import normalize_imagenet
    from ncnet_tpu_torch.training import (
        auto_accum_chunks,
        create_train_state,
        make_train_step,
        weak_loss_and_grads,
    )

    cfg = TrainConfig(model=model or ModelConfig(
        backbone="resnet101", ncons_kernel_sizes=(5, 5, 5),
        ncons_channels=(16, 16, 1), half_precision=True), **train_kw)
    state, optimizer, mc, _ = create_train_state(cfg, seed=0)
    rng = np.random.default_rng(1)
    shape = (cfg.batch_size, cfg.image_size, cfg.image_size, 3)

    def pair():
        src = rng.integers(0, 256, shape, dtype=np.uint8)
        return {"source_image": src,
                "target_image": np.roll(src, TRAIN_SHIFT, axis=(1, 2))}

    batches = [{k: normalize_imagenet(torch.as_tensor(v).to(dev))
                for k, v in pair().items()} for _ in range(TRAIN_STEPS + 2)]
    contrast = [feature_contrast(mc, state.params, batches[0])]
    calibrate_trunk(mc, state.params, batches.pop()["source_image"])
    contrast.append(feature_contrast(mc, state.params, batches[0]))
    print("train: trunk features, cosine of a source cell with the target "
          "cells of its pair (mean, mean best): raw BatchNorm init "
          f"{contrast[0]}, calibrated {contrast[1]}", flush=True)
    # NC kernels centre-peaked (the CPU tests' peaked_params), so that the
    # filtered volume keeps the match peaks, and biases off zero: a
    # random-init stack on a mutual-matched volume otherwise sits at the
    # ReLU boundary
    for layer in state.params["nc"]:
        d = layer["w"].shape[0] // 2
        layer["w"][d, d, d, d] += 1.0 / layer["w"].shape[4]
        layer["b"] = layer["b"] + 0.05
    step = make_train_step(mc, optimizer, stop_backbone_grad=True,
                           accum_chunks=cfg.accum_chunks,
                           nan_guard=cfg.nan_guard)
    chunks = auto_accum_chunks(cfg.batch_size)
    n_layers = len(mc.ncons_channels)

    state, loss = step(state, batches[-1])  # warm-up, not counted
    torch.cuda.synchronize()
    print(f"train: warm-up step loss {float(loss):.9g}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    nc_fused_lane.launches = 0
    for key in vjp.launches:
        vjp.launches[key] = 0
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, loss = step(state, batches[i])
        loss = float(loss)  # the NaN guard has synchronised already
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        print(f"train step {i + 1}: loss {loss:.9g}, wall {wall:.1f} ms, "
              f"peak memory {peak} bytes", flush=True)
        if not np.isfinite(loss):
            raise SystemExit(f"train step {i + 1}: non-finite loss")
    launches = {"nc_conv4d_bf16": nc_fused_lane.launches, **vjp.launches}
    # per step: each chunk runs the folded stack once forward (one launch
    # per layer) and once backward (dW/db and its reduction per layer, the
    # transposed conv for every layer but the first: the volume needs no
    # gradient)
    want = {"nc_conv4d_bf16": TRAIN_STEPS * chunks * n_layers,
            "nc_vjp_dw": TRAIN_STEPS * chunks * n_layers,
            "nc_vjp_reduce": TRAIN_STEPS * chunks * n_layers,
            "nc_conv4d_transpose": TRAIN_STEPS * chunks * (n_layers - 1)}
    print(f"train: launches in {TRAIN_STEPS} steps {launches}, expected "
          f"{want} ({chunks} chunks of {2 * cfg.batch_size // chunks} "
          "volumes a step)", flush=True)
    if launches != want:
        raise SystemExit("the training path did not launch the kernels as expected")

    # the step's loss and NC gradients, kernels vs twins in both directions
    # (and a reordered twin as the control of the spread), and the kernels
    # vs the twin on the last chunk's exact volume and cotangent
    batch = batches[0]
    calls = []
    with routed_fused_stack(nc_fused_lane.nc_stack_fused, calls):
        loss_k, grads_k = weak_loss_and_grads(mc, state.params, batch)
    with routed_fused_stack(twin_stack_fused):
        loss_t, grads_t = weak_loss_and_grads(mc, state.params, batch)
    layer = reordered_layer((2, 3, 0, 1))
    with routed_fused_stack(lambda p, v: twin_stack_fused(p, v, layer)):
        control = weak_loss_and_grads(mc, state.params, batch)
    with torch.no_grad():
        scores = pair_scores(mc, state.params, batch, chunks)
    torch.cuda.synchronize()
    step_check(loss_k, grads_k, loss_t, grads_t, control, scores)
    params, x, _, g = calls[-1]
    params = [{k: v.detach() for k, v in p.items()} for p in params]
    acts = nc_fused_lane.stack_activations(params, x)
    err, max_abs = grads_err(vjp.stack_vjp(params, acts, g, need_dx=False),
                             vjp.stack_vjp(params, acts, g, need_dx=False,
                                           twin=True))
    print(f"train: B3 on the last chunk's volume {tuple(x.shape)}: kernels vs "
          f"twin max_abs_err {max_abs:.6g} normalized {err:.3e} (tolerance "
          f"{TOLERANCE})", flush=True)
    if not err <= TOLERANCE:
        raise SystemExit("the backward kernels disagree with the twin on the "
                         "training volume")
    train_stages(torch, nc_fused_lane, vjp, mc, state, optimizer, batch,
                 params, x, g, chunks)
    return launches


def train_stages(torch, nc_fused_lane, vjp, mc, state, optimizer, batch,
                 params, x, g, chunks):
    """CUDA-event ms of a step's stages, each run alone and warm: the trunk
    (both sides), the NC stack forward and backward (one chunk's, times
    the chunks), the rest of a chunk's forward and backward (correlation,
    mutual matching, scores; times the chunks), and Adam with the NaN
    guard's check."""
    from ncnet_tpu_torch.models.ncnet import extract_features, ncnet_filter
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.training import match_score_per_pair
    from ncnet_tpu_torch.training.train import (
        apply_updates,
        tree_leaves,
        tree_map,
    )

    with torch.no_grad():
        fa = extract_features(mc, state.params, batch["source_image"]).to(torch.bfloat16)
        fb = extract_features(mc, state.params, batch["target_image"]).to(torch.bfloat16)
    c = x.shape[0] // 2  # pairs per chunk (the stack folds their transposes)
    acts = nc_fused_lane.stack_activations(params, x)

    def chunk():
        leaves = [{k: v.detach().requires_grad_() for k, v in layer.items()}
                  for layer in state.params["nc"]]
        with torch.enable_grad():
            vol = ncnet_filter(mc, {**state.params, "nc": leaves},
                               correlation_4d(fa[:c], fb[:c])).corr
            val = match_score_per_pair(vol).sum()
        return torch.autograd.grad(val, [t for p in leaves for t in p.values()])

    def trunk():
        with torch.no_grad():
            return (extract_features(mc, state.params, batch["source_image"]),
                    extract_features(mc, state.params, batch["target_image"]))

    grads = {"backbone": tree_map(torch.zeros_like, state.params["backbone"]),
             "nc": tree_map(torch.ones_like, state.params["nc"])}

    def adam():
        updates, _ = optimizer.update(grads, state.opt_state, state.params)
        new = apply_updates(state.params, updates)
        ok = torch.ones((), dtype=torch.bool, device=x.device)
        for u in tree_leaves(updates):
            ok = ok & torch.isfinite(u).all()
        return new, ok

    nc_fwd = cuda_ms(lambda: nc_fused_lane.stack_activations(params, x), 3)
    nc_bwd = cuda_ms(lambda: vjp.stack_vjp(params, acts, g, need_dx=False), 3)
    chunk_ms = cuda_ms(chunk, 3)
    stages = {
        f"trunk, both sides, batch {batch['source_image'].shape[0]}":
            cuda_ms(trunk, 3),
        f"NC stack forward (B2), {chunks} chunks": nc_fwd * chunks,
        f"NC stack backward (B3), {chunks} chunks": nc_bwd * chunks,
        f"correlation, mutual matching, loss; forward and backward, {chunks} "
        "chunks": (chunk_ms - nc_fwd - nc_bwd) * chunks,
        "Adam and the NaN guard's check": cuda_ms(adam, 3),
    }
    print("train stages ms per step: " + json.dumps(stages), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "ncnet_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from ncnet_tpu_torch.ops import kernel_build, nc_fused_lane, nc_fused_lane_vjp

    print(card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: torch.backends.cuda.matmul.allow_tf32=False, "
          "torch.backends.cudnn.allow_tf32=False", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    logs = kernel_build.build()
    print(f"build: {sorted(logs) or 'cached'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for src, log in logs.items():
        spills = [ln for ln in log.splitlines()
                  if "spill" in ln and not ln.strip().endswith(
                      "0 bytes spill stores, 0 bytes spill loads")]
        regs = [ln.split("Used", 1)[1].strip() for ln in log.splitlines()
                if "Used" in ln and "registers" in ln]
        print(f"build {src}: {len(regs)} kernels; registers/smem: {regs}; "
              f"spilling: {spills or 'none'}", flush=True)

    dev = torch.device("cuda", 0)
    main_numbers = check_kernels(torch, nc_fused_lane, dev)
    backward_numbers = check_backward(torch, nc_fused_lane, nc_fused_lane_vjp, dev)
    serve_launches = serve(torch, nc_fused_lane, dev)
    train_launches = train(torch, nc_fused_lane, nc_fused_lane_vjp, dev)

    kernels = [{
        "name": "nc_conv4d_bf16",
        "route": "cuda",
        "source": "ncnet_tpu_torch/csrc/nc_conv4d.cu",
        # nc_stack_resident, the whole-stack kernel the bf16 path takes; the
        # per-layer _conv_fused_lane is one launch of the same kernel
        "replaces": "ncnet_tpu/ops/nc_fused_lane.py:606",
        "also_replaces": "ncnet_tpu/ops/nc_fused_lane.py:121",
        # each path read with its counts set to 0 just before it
        "launches": serve_launches + train_launches["nc_conv4d_bf16"],
        "launches_by_path": {"serve": serve_launches,
                             "train": train_launches["nc_conv4d_bf16"]},
        **main_numbers,
        # no single PyTorch call computes a 4D convolution
        "library_ms": None,
    }, {
        "name": "nc_vjp (nc_vjp_dw_bf16, nc_vjp_reduce_f32, nc_conv4d_transpose_bf16)",
        "route": "cuda",
        "source": "ncnet_tpu_torch/csrc/nc_conv4d_vjp.cu",
        "also_source": "ncnet_tpu_torch/csrc/nc_conv4d.cu",
        "replaces": "ncnet_tpu/ops/nc_fused_lane_vjp.py:490",
        # the three kernels' launches in the timed training steps
        "launches": sum(train_launches[k] for k in nc_fused_lane_vjp.launches),
        "launches_by_kernel": {k: train_launches[k]
                               for k in nc_fused_lane_vjp.launches},
        **backward_numbers,
        # no single PyTorch call computes a conv4d backward
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
