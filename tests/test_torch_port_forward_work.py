"""The whole forward's work on the CPU: ``observability/roofline.py``'s
``trunk_work``, ``correlation_work`` and ``forward_work`` (the algorithmic
count) and ``tools/_work.py::executed_work`` (the executed one).

  * ``trunk_work`` at taps inside the image against XLA's cost analysis of
    the JAX ``extract_features``, lowered from abstract weights: XLA counts
    the same multiply-adds and, besides, each elementwise op (BatchNorm 2 a
    value, ReLU, residual and bias adds 1, a max pool's window less one,
    the L2 norm), so its count is above ours by at most that share;
  * ``trunk_work(every_tap=True)`` equals ``FlopCounterMode`` over the
    port's own trunk, so both tap conventions are pinned;
  * ``forward_work`` is the sum of its parts and reads no tier or precision;
  * the executed count of the FFT route is FlopCounterMode's total plus the
    transforms' 5·N·log₂N convention, and of a per-layer conv4d route and
    the B6 twin route FlopCounterMode's total alone; a kernel's launch is
    counted at its roofline work.
"""

import math
import warnings

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from ncnet_tpu import config as jcfg
from ncnet_tpu.models import ncnet as jnet
from ncnet_tpu_torch import config as tcfg
from ncnet_tpu_torch.models import ncnet as tnet
from ncnet_tpu_torch.observability import roofline
from ncnet_tpu_torch.ops import nc_fused_lane
from ncnet_tpu_torch.tools import _work

KERNELS, CHANNELS = (5, 5, 5), (16, 16, 1)
# XLA's count over ours, at most: each trunk's elementwise ops as a share of
# its multiply-adds, measured 0.435 %, 1.110 %, 0.123 % and 0.927 % at these
# sides (XLA's CPU compiler rewrites the program and its compiled count is
# higher: 4.364·10⁹ for ResNet-101 at 128², 2.4 % over ours)
XLA_SIDES = {"resnet101": (128, 0.005), "tiny": (128, 0.012),
             "vgg": (64, 0.002), "densenet201": (64, 0.01)}


def _random_trunk_init(fn):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-trunk warning
        return fn()


@pytest.mark.parametrize("backbone", sorted(XLA_SIDES))
def test_trunk_work_agrees_with_xla(backbone):
    side, rtol = XLA_SIDES[backbone]
    jc = jcfg.ModelConfig(backbone=backbone)
    shapes = _random_trunk_init(
        lambda: jax.eval_shape(lambda: jnet.init_ncnet(jc, jax.random.key(0))))
    lowered = jax.jit(lambda p, x: jnet.extract_features(jc, p, x)).lower(
        shapes, jax.ShapeDtypeStruct((1, side, side, 3), jnp.float32))
    cost = lowered.cost_analysis()
    xla = (cost[0] if isinstance(cost, list) else cost)["flops"]
    ours, _ = roofline.trunk_work(backbone, "", 1, side)
    assert 0 < xla - ours <= rtol * ours, (xla, ours)


@pytest.mark.parametrize("backbone", sorted(XLA_SIDES))
def test_trunk_work_every_tap_is_flop_counters(backbone):
    side = XLA_SIDES[backbone][0]
    cfg = tcfg.ModelConfig(backbone=backbone)
    params = _random_trunk_init(lambda: tnet.init_ncnet(cfg, seed=0))
    images = torch.zeros((1, side, side, 3))
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        feats = tnet.extract_features(cfg, params, images)
    every, nbytes = roofline.trunk_work(backbone, "", 1, side, every_tap=True)
    assert fc.get_total_flops() == every
    assert every > roofline.trunk_work(backbone, "", 1, side)[0]
    if backbone == "resnet101":
        assert every == 4_564_975_616
    # bytes: the images, the weights (and biases) and the features once
    weights = sum(t.numel() for k, t in _conv_weights(params["backbone"]))
    assert nbytes == 2 * (3 * side * side + weights + feats.numel())


def _conv_weights(tree, path=""):
    """Each conv's weight and bias (BatchNorm vectors are not counted)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                if k in ("w", "b") and "norm" not in path and "bn" not in path:
                    yield path + k, v
            else:
                yield from _conv_weights(v, f"{path}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _conv_weights(v, f"{path}{i}.")


def test_forward_work_is_the_sum_of_its_parts_on_any_tier():
    """The PF-Pascal forward at batch 4 of 400² pairs: the trunk on 8
    images, the 25⁴ correlation of 1024 channels, the filter's 231.0 GFLOP
    a pair; the same count whatever tier or precision is configured."""
    base = tcfg.ModelConfig(ncons_kernel_sizes=KERNELS,
                            ncons_channels=CHANNELS, half_precision=True,
                            backbone_bf16=True)
    flops, nbytes = roofline.forward_work(base, 4, 400)
    parts = (roofline.trunk_work("resnet101", "", 8, 400),
             roofline.correlation_work(4, 25, 25, 25, 25, 1024),
             roofline.filter_work(4, 25, 1024, KERNELS, CHANNELS))
    assert flops == sum(p[0] for p in parts)
    # the filter's bytes, from the features, hold the correlation's
    assert nbytes == parts[0][1] + parts[2][1]
    assert parts[1][0] == 2 * 4 * 25 ** 4 * 1024
    assert parts[2][0] == 4 * 4 * 119 ** 4 * 288
    # the trunk scales with the pixels: a quarter of the forward here
    assert 0.2 < parts[0][0] / flops < 0.3
    for cfg in (base.replace(nc_tier="fft"), base.replace(nc_tier="cp"),
                base.replace(half_precision=False)):
        assert roofline.forward_work(cfg, 4, 400)[0] == flops
    with pytest.raises(ValueError, match="dense symmetric"):
        roofline.forward_work(base.replace(sparse_topk=4), 4, 400)


def _fft_layer(b, n, k, c_in, c_out):
    """The stated convention for one ``conv4d_fft`` on ``b`` volumes of
    side ``n``: the input's real transform over the last axis and complex
    one over the first three (at the padded side s = n + k − 1), the
    weight's the same, the inverse's complex then real; and six FLOPs a
    complex multiply-add where the contraction is a matrix product (a
    1-channel input's is a broadcast product, which no counter counts)."""
    s, h = n + k - 1, (n + k - 1) // 2 + 1
    n3, log3, log1 = s ** 3, math.log2(s ** 3), math.log2(s)
    flops = (2.5 * b * n ** 3 * s * c_in * log1
             + 5.0 * b * n3 * h * c_in * log3
             + 2.5 * k ** 3 * s * c_in * c_out * log1
             + 5.0 * n3 * h * c_in * c_out * log3
             + 5.0 * b * n3 * h * c_out * log3
             + 2.5 * b * n3 * s * c_out * log1)
    if c_in > 1:
        flops += 6 * b * n3 * h * c_in * c_out
    return flops


def _forward(cfg, side):
    params = tnet.init_ncnet(cfg, seed=0)
    g = torch.Generator().manual_seed(0)
    src, tgt = (torch.rand((1, side, side, 3), generator=g) * 2 - 1
                for _ in range(2))
    return lambda: tnet.ncnet_forward(cfg, params, src, tgt).corr


@pytest.mark.parametrize("route,half,side", [("fft", True, 128),
                                            ("xla", False, 64),
                                            ("resident", True, 64)])
def test_executed_count_is_the_stated_formula(route, half, side):
    """The tiny trunk and the PF-Pascal stack, one pair: at 128² the 8⁴
    volume takes the FFT tier; at 64² the 4⁴ one takes the per-layer
    formulations in fp32 and the B6 twin in bf16 (no launch on the CPU)."""
    cfg = tcfg.ModelConfig(backbone="tiny", ncons_kernel_sizes=KERNELS,
                           ncons_channels=CHANNELS, half_precision=half,
                           backbone_bf16=half)
    fwd = _forward(cfg, side)
    with torch.no_grad():
        want = fwd()
        with FlopCounterMode(display=False) as fc:
            fwd()
        got, ex = _work.executed_work(fwd)
    assert nc_fused_lane.last_selected_tier() == route
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    spectral = 0.0
    if route == "fft":
        n, c_in = side // 16, 1
        for c_out in CHANNELS:  # the folded pair: two volumes
            spectral += _fft_layer(2, n, 5, c_in, c_out)
            c_in = c_out
    assert ex.library == fc.get_total_flops() > 0
    assert ex.spectral == pytest.approx(spectral, rel=1e-12, abs=0)
    assert ex.total == pytest.approx(fc.get_total_flops() + spectral,
                                     rel=1e-12)
    assert ex.launches == dict.fromkeys(_work.KERNELS, 0)
    assert set(ex.kernels.values()) == {0.0}


def test_a_launch_counts_at_its_roofline_work(monkeypatch):
    """A wrapper that counts a launch (here a CPU stand-in for the card's
    B6 launch) adds that launch's in-volume work, and only for the call."""
    def launching(x, w, b):
        nc_fused_lane.launches += 1
        return nc_fused_lane.layer_reference(x, w, b)

    monkeypatch.setattr(nc_fused_lane, "nc_conv4d_layer", launching)
    monkeypatch.setattr(nc_fused_lane, "launches", 0)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 4, 4, 4, 4, 1), generator=g).to(torch.bfloat16)
    w = (torch.randn((3, 3, 3, 3, 1, 8), generator=g) * 0.1).to(torch.bfloat16)
    b = torch.zeros(8, dtype=torch.bfloat16)
    _, ex = _work.executed_work(
        lambda: [nc_fused_lane.nc_conv4d_layer(x, w, b) for _ in range(3)])
    per_launch = roofline.stack_work((2, 4, 4, 4, 4), (3,), (8,))[0]
    assert ex.launches["nc_conv4d_bf16"] == 3
    assert ex.kernels["nc_conv4d_bf16"] == 3 * per_launch
    assert ex.total == ex.library + 3 * per_launch
    assert nc_fused_lane.nc_conv4d_layer is launching
