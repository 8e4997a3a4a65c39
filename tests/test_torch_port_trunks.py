"""The port's VGG-16 and DenseNet-201 trunks (``ncnet_tpu_torch/models/
backbone.py``) and everything that reads them — the torchvision and
reference importers, the fine-tune labels, the payload digest, the full
forward and the fine-tuned training step — against the JAX package on the
CPU.

Both packages get the same weights: the JAX random init carried into the
port by ``params_from_numpy``, or a torchvision-named state dict drawn
from seeded numpy and saved with ``torch.save`` (no real ImageNet weights
are in the repository).

Tolerances, each with its reason:
  * trunk features: rtol 1e-5 and atol 1e-5 of the map's largest value
    (the two libraries' fp32 convolutions sum in different orders; a
    per-element atol of 1e-5 absolute would be tighter than fp32 rounding
    for the deep VGG cuts, whose values reach ~10²);
  * importers, labels, digests and config fields: exactly equal;
  * ``ncnet_forward``: rtol and atol 2e-4 (``tests/test_torch_port_model.py``'s
    bound for the full model);
  * the fine-tuned step: the loss to 1e-6 absolute, the trunk gradients
    to 1e-4 of each tensor's largest entry (the fit tests' fp32 bound),
    the NC gradients to ``NC_GRAD_ATOL`` of theirs: the last layer's bias
    gradient is one sum over the whole volume of terms of both signs that
    nearly cancel at this near-zero loss (2.5e-4 apart measured at VGG-16).
"""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ncnet_tpu import config as jcfg
from ncnet_tpu.models import backbone as jbb
from ncnet_tpu.models import checkpoint as jckpt
from ncnet_tpu.models import ncnet as jnet
from ncnet_tpu.training import loss as jloss
from ncnet_tpu_torch import config as tcfg
from ncnet_tpu_torch.models import backbone as tbb
from ncnet_tpu_torch.models import checkpoint as tckpt
from ncnet_tpu_torch.models import ncnet as tnet
from ncnet_tpu_torch.models.convert import params_from_numpy
from ncnet_tpu_torch.serving.engine import BatchMatchEngine
from ncnet_tpu_torch.training import loss as tloss
from ncnet_tpu_torch.training import train as ttrain

TRUNKS = ("vgg", "densenet201")
NC_GRAD_ATOL = 1e-3
# every VGG-16 unit by its reference name, conv1_1 to pool5
VGG_CUTS = []
for _b, _n in enumerate((2, 2, 3, 3, 3), start=1):
    VGG_CUTS += [f"{kind}{_b}_{i}" for i in range(1, _n + 1)
                 for kind in ("conv", "relu")]
    VGG_CUTS.append(f"pool{_b}")


def images(seed, shape):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def assert_features_close(got, want):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def assert_trees_equal(got, want):
    """A port tree against a JAX-layout numpy tree, carried over by
    ``params_from_numpy``: the same keys, the same values bit for bit."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_trees_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert_trees_equal(a, b)
    else:
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.fixture(scope="module")
def trunk_params():
    """JAX random init of each trunk (VGG-16 through pool5) and the same
    weights in the port."""
    out = {}
    for name, cut in (("vgg", "pool5"), ("densenet201", "")):
        jp = jbb.backbone_init(name, jax.random.key(7), last_layer=cut)
        out[name] = (jp, params_from_numpy(
            {"nc": [], "backbone": jax.tree.map(np.asarray, jp)})["backbone"])
    return out


# ---------------------------------------------------------------------------
# features
# ---------------------------------------------------------------------------


def test_vgg_cut_names_are_the_jax_names():
    assert len(VGG_CUTS) == 31
    for cut in VGG_CUTS:
        assert tbb._vgg_units(cut) == jbb._vgg_units(cut)
    assert tbb._vgg_units("") == jbb._vgg_units("pool4")
    with pytest.raises(ValueError, match="unsupported vgg cut"):
        tbb._vgg_units("layer3")
    with pytest.raises(ValueError, match="only 'transition2'"):
        tbb.backbone_init("densenet201", torch.Generator(), last_layer="x")
    assert tbb.OUTPUT_CHANNELS == jbb.OUTPUT_CHANNELS
    assert tbb.OUTPUT_STRIDE == jbb.OUTPUT_STRIDE


@pytest.mark.parametrize("cut", VGG_CUTS + [""])
def test_vgg_features_match_jax(trunk_params, cut):
    """Every cut of the full-width VGG-16 on a seeded 64 × 64 batch (a
    cut at a conv name ends on the raw conv)."""
    jp, tp = trunk_params["vgg"]
    x = images(1, (2, 64, 64, 3))
    want = jbb.backbone_apply("vgg", jp, jnp.asarray(x), last_layer=cut)
    with torch.no_grad():
        got = tbb.backbone_apply("vgg", tp, torch.from_numpy(x), last_layer=cut)
    assert_features_close(got, want)
    if cut.startswith("conv"):
        assert float(got.min()) < 0  # no trailing ReLU
    if cut == "":
        assert got.shape == (2, 4, 4, 512)


@pytest.mark.parametrize("hw", [(64, 64), (80, 48)])
def test_densenet_features_match_jax(trunk_params, hw):
    jp, tp = trunk_params["densenet201"]
    x = images(2, (2,) + hw + (3,))
    want = jbb.backbone_apply("densenet201", jp, jnp.asarray(x))
    with torch.no_grad():
        got = tbb.backbone_apply("densenet201", tp, torch.from_numpy(x))
    assert got.shape == (2, hw[0] // 16, hw[1] // 16, 256)
    assert_features_close(got, want)


@pytest.mark.parametrize("name", TRUNKS)
def test_random_init_has_the_jax_shapes(name):
    """The port's own init draws from an explicit generator: the same tree
    and shapes as the JAX init (the numbers differ: another generator),
    He-scaled, and the same draw for the same seed."""
    jp = jax.tree.map(np.asarray, jbb.backbone_init(name, jax.random.key(0)))
    tp = tbb.backbone_init(name, torch.Generator().manual_seed(0))
    again = tbb.backbone_init(name, torch.Generator().manual_seed(0))
    want = params_from_numpy({"nc": [], "backbone": jp})["backbone"]
    got_leaves = list(tckpt._jax_leaves({"backbone": tp}))
    want_leaves = list(tckpt._jax_leaves({"backbone": want}))
    assert len(got_leaves) == len(want_leaves)
    for (g, _, _), (w, _, _) in zip(got_leaves, want_leaves):
        assert g.shape == w.shape and g.dtype == w.dtype
    for (g, _, _), (a, _, _) in zip(got_leaves, tckpt._jax_leaves({"backbone": again})):
        assert torch.equal(g, a)


# ---------------------------------------------------------------------------
# importers
# ---------------------------------------------------------------------------


def torchvision_state_dict(name, seed=0):
    """A whole torchvision ``vgg16`` / ``densenet201`` state dict of seeded
    numpy values: the trunk nested under ``features.`` (VGG-16 through
    pool5, DenseNet-201 with its later blocks), a classifier, and the
    ``num_batches_tracked`` buffers."""
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return torch.from_numpy(rng.normal(0, 0.1, shape).astype(np.float32))

    sd = {}

    def bn(prefix, c):
        sd[prefix + ".weight"] = arr(c) + 1.0
        sd[prefix + ".bias"] = arr(c)
        sd[prefix + ".running_mean"] = arr(c)
        sd[prefix + ".running_var"] = arr(c).abs() + 0.5
        sd[prefix + ".num_batches_tracked"] = torch.zeros((), dtype=torch.int64)

    if name == "vgg":
        cin = 3
        for i, cout in zip(tbb._vgg_conv_indices("pool5"),
                           [c for c in tbb.VGG16_PLAN if c != -1]):
            sd[f"features.{i}.weight"] = arr(cout, cin, 3, 3)
            sd[f"features.{i}.bias"] = arr(cout)
            cin = cout
        sd["classifier.0.weight"] = arr(8, 4)
        return sd
    sd["features.conv0.weight"] = arr(64, 3, 7, 7)
    bn("features.norm0", 64)
    c = 64
    for bi, n_layers in enumerate((6, 12, 48), start=1):
        for i in range(1, n_layers + 1):
            p = f"features.denseblock{bi}.denselayer{i}"
            bn(p + ".norm1", c)
            sd[p + ".conv1.weight"] = arr(128, c, 1, 1)
            bn(p + ".norm2", 128)
            sd[p + ".conv2.weight"] = arr(32, 128, 3, 3)
            c += 32
        bn(f"features.transition{bi}.norm", c)
        sd[f"features.transition{bi}.conv.weight"] = arr(c // 2, c, 1, 1)
        c //= 2
    sd["classifier.weight"] = arr(8, 4)
    return sd


@pytest.fixture(scope="module")
def state_dicts():
    return {name: torchvision_state_dict(name, seed=i)
            for i, name in enumerate(TRUNKS)}


@pytest.mark.parametrize("name,cut", [("vgg", ""), ("vgg", "conv3_2"),
                                      ("vgg", "pool5"), ("densenet201", "")])
def test_import_torch_backbone_matches_jax(state_dicts, name, cut):
    """Prefix-stripped and through the ``features.`` prefix argument."""
    sd = state_dicts[name]
    stripped = {k[len("features."):]: v for k, v in sd.items()
                if k.startswith("features.")}
    want = params_from_numpy({"nc": [], "backbone": jax.tree.map(
        np.asarray, jbb.import_torch_backbone(stripped, name, last_layer=cut))})
    for got in (tbb.import_torch_backbone(stripped, name, last_layer=cut),
                tbb.import_torch_backbone(sd, name, prefix="features.",
                                          last_layer=cut)):
        assert_trees_equal(got, want["backbone"])


@pytest.mark.parametrize("name", TRUNKS)
def test_backbone_weights_file_matches_jax(state_dicts, tmp_path, name):
    """``ModelConfig.backbone_weights``: a whole torchvision state dict
    (``features.`` stripped by the loader, as the JAX loader does) gives
    the JAX package's trunk; no random-trunk warning then."""
    path = str(tmp_path / f"{name}.pth")
    torch.save(state_dicts[name], path)
    kw = dict(backbone=name, backbone_weights=path, ncons_kernel_sizes=(3,),
              ncons_channels=(1,))
    want = jax.tree.map(np.asarray, jnet.init_ncnet(jcfg.ModelConfig(**kw),
                                                    jax.random.key(0)))
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = tnet.init_ncnet(tcfg.ModelConfig(**kw), seed=0)
    assert_trees_equal(got["backbone"], params_from_numpy(want)["backbone"])


@pytest.mark.parametrize("name", TRUNKS)
def test_random_pretrained_kind_trunk_warns(name):
    with pytest.warns(UserWarning, match="RANDOM weights"):
        tnet.init_ncnet(tcfg.ModelConfig(backbone=name, ncons_kernel_sizes=(3,),
                                         ncons_channels=(1,)))


def reference_checkpoint(sd_features, name, legacy_vgg_keys):
    """A reference ``.pth.tar`` dict: the trunk under
    ``FeatureExtraction.model.`` (``FeatureExtraction.vgg.`` with the
    legacy naming), a 2-layer NC stack in the stored Conv4d layout, and
    the argparse args."""
    rng = np.random.default_rng(5)
    trunk = "FeatureExtraction.vgg." if legacy_vgg_keys else "FeatureExtraction.model."
    sd = {trunk + k[len("features."):]: v for k, v in sd_features.items()
          if k.startswith("features.")}
    c_in = 1
    for j, (k, c_out) in enumerate(((3, 4), (3, 1))):
        sd[f"NeighConsensus.conv.{2 * j}.weight"] = torch.from_numpy(
            rng.normal(0, 0.1, (k, c_out, c_in, k, k, k)).astype(np.float32))
        sd[f"NeighConsensus.conv.{2 * j}.bias"] = torch.from_numpy(
            rng.normal(0, 0.1, (c_out,)).astype(np.float32))
        c_in = c_out
    args = argparse.Namespace(ncons_kernel_sizes=[3, 3], ncons_channels=[4, 1],
                              feature_extraction_cnn=name,
                              feature_extraction_last_layer="")
    return {"epoch": 1, "args": args, "state_dict": sd}


@pytest.mark.parametrize("name,legacy", [("vgg", True), ("vgg", False),
                                         ("densenet201", False)])
def test_reference_checkpoint_imports_as_jax(state_dicts, tmp_path, name, legacy):
    """A ``.pth.tar`` whose args say ``feature_extraction_cnn=<trunk>``
    (with the legacy ``vgg`` keys for VGG) imports as in the JAX package:
    the architecture from the args, the same weights; it loads as a model
    through ``ModelConfig.checkpoint``."""
    path = str(tmp_path / "model.pth.tar")
    torch.save(reference_checkpoint(state_dicts[name], name, legacy), path)
    jc, jp = jckpt.import_torch_checkpoint(path, jcfg.ModelConfig())
    tc, tp = tckpt.import_torch_checkpoint(path, tcfg.ModelConfig())
    assert tc.backbone == jc.backbone == name
    assert tuple(tc.ncons_kernel_sizes) == tuple(jc.ncons_kernel_sizes) == (3, 3)
    assert_trees_equal(tp, params_from_numpy(jax.tree.map(np.asarray, jp)))
    model = tnet.NCNet(tcfg.ModelConfig(backbone=name, checkpoint=path),
                       device="cpu")
    assert_trees_equal(model.params["nc"], tp["nc"])


@pytest.mark.parametrize("name", TRUNKS)
def test_reference_state_dict_round_trips(state_dicts, tmp_path, name):
    """The port's weights written in the reference layout read back, by
    the port and by the JAX package, as the same weights."""
    cfg = tcfg.ModelConfig(backbone=name, ncons_kernel_sizes=(3, 3),
                           ncons_channels=(4, 1))
    stripped = {k[len("features."):]: v for k, v in state_dicts[name].items()
                if k.startswith("features.")}
    params = {"backbone": tbb.import_torch_backbone(stripped, name),
              "nc": tnet.init_ncnet(cfg.replace(backbone="tiny"), seed=2)["nc"]}
    path = str(tmp_path / "ref.pth.tar")
    torch.save({"state_dict": tckpt.reference_state_dict(cfg, params),
                "args": argparse.Namespace(feature_extraction_cnn=name,
                                           ncons_kernel_sizes=[3, 3],
                                           ncons_channels=[4, 1])}, path)
    _, tp = tckpt.import_torch_checkpoint(path)
    assert_trees_equal(tp, params)
    _, jp = jckpt.import_torch_checkpoint(path, jcfg.ModelConfig())
    assert_trees_equal(params, params_from_numpy(jax.tree.map(np.asarray, jp)))


# ---------------------------------------------------------------------------
# fine-tune labels, payload digest
# ---------------------------------------------------------------------------


def unit_count(name, params):
    if name == "vgg":
        return len(params["convs"])
    return 1 + len(params["denseblock2"])


@pytest.mark.parametrize("name", TRUNKS)
@pytest.mark.parametrize("n", [0, 1, 3, "all"])
def test_finetune_labels_match_jax(trunk_params, name, n):
    jp, tp = trunk_params[name]
    n = unit_count(name, tp) if n == "all" else n
    got = tbb.finetune_labels(name, tp, n)
    want = jbb.finetune_labels(name, jp, n)

    def same(g, w):
        if isinstance(w, dict):
            assert sorted(g) == sorted(w)
            for k in w:
                same(g[k], w[k])
        elif isinstance(w, (list, tuple)):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                same(a, b)
        else:
            assert g == w

    same(got, want)
    flat = jax.tree.leaves(want)
    assert ("trainable" in flat) == (n > 0)
    # BN running statistics never train
    if name == "densenet201":
        assert got["transition2"]["norm"]["mean"] == "frozen"


@pytest.mark.parametrize("name", TRUNKS)
@pytest.mark.parametrize("bf16", [False, True])
def test_payload_sha_equals_jax(name, bf16):
    kw = dict(backbone=name, ncons_kernel_sizes=(3, 3), ncons_channels=(4, 1))
    jp = jnet.init_ncnet(jcfg.ModelConfig(**kw), jax.random.key(3))
    if bf16:
        jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    assert tckpt.params_payload_sha256(tp) == jckpt.params_payload_sha256(jp)


# ---------------------------------------------------------------------------
# the model with each trunk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", TRUNKS)
def test_ncnet_forward_matches_jax(name):
    """The full forward at 200² (a 12⁴ volume with either trunk)."""
    kw = dict(backbone=name, ncons_kernel_sizes=(3, 3), ncons_channels=(4, 1))
    jc, tc = jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)
    jp = jnet.init_ncnet(jc, jax.random.key(4))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    xa, xb = images(5, (1, 200, 200, 3)), images(6, (1, 200, 200, 3))
    want = jnet.ncnet_forward(jc, jp, jnp.asarray(xa), jnp.asarray(xb)).corr
    with torch.no_grad():
        got = tnet.ncnet_forward(tc, tp, torch.from_numpy(xa),
                                 torch.from_numpy(xb)).corr
    assert got.shape == (1, 12, 12, 12, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    # the serving engine builds with the trunk
    BatchMatchEngine(tc, tp, device="cpu")


@pytest.mark.parametrize("name", TRUNKS)
def test_finetuned_step_gradients_match_jax(name):
    """``fe_finetune_params=1`` through the whole-batch backward: the loss
    and the gradients of the one unfrozen trunk unit (VGG-16's last conv
    before pool4, DenseNet-201's transition2) against ``jax.grad`` of the
    JAX loss; the frozen units get none."""
    kw = dict(backbone=name, ncons_kernel_sizes=(3, 3), ncons_channels=(4, 1))
    jc, tc = jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)
    jp = jnet.init_ncnet(jc, jax.random.key(8))
    # centre-peaked NC kernels: the filtered volume keeps the correlation's
    # peaks, so the shifted pairs score apart from the rolled ones (a
    # near-zero loss would make every gradient a difference of equal terms)
    rng = np.random.default_rng(0)
    for layer in jp["nc"]:
        w = rng.normal(0, 0.05, layer["w"].shape).astype(np.float32)
        w[1, 1, 1, 1] += 1.0 / w.shape[4]
        layer["w"] = jnp.asarray(w)
        layer["b"] = jnp.full(layer["b"].shape, 0.05, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    src = images(9, (2, 64, 64, 3))
    batch = {"source_image": src,
             "target_image": np.roll(src, (16, 16), axis=(1, 2)).copy()}
    jval, jgrad = jax.value_and_grad(lambda p: jloss.weak_loss(
        jc, p, {k: jnp.asarray(v) for k, v in batch.items()}))(jp)
    labels = ttrain.trainable_labels(tc, tp, 1)
    trainable = tnet.tree_map(lambda lbl: lbl == "trainable", labels)
    tval, tgrad = ttrain._value_and_grad(lambda p: tloss.weak_loss(
        tc, p, {k: torch.from_numpy(v) for k, v in batch.items()}), tp, trainable)
    np.testing.assert_allclose(float(tval), float(jval), rtol=0, atol=1e-6)
    assert abs(float(jval)) > 1e-4  # not a flat volume
    jg = params_from_numpy(jax.tree.map(np.asarray, jgrad))
    n_trained = 0
    for (g, in_trunk, _), (w, _, _), (lbl, _, _) in zip(
            tckpt._jax_leaves(tgrad), tckpt._jax_leaves(jg),
            tckpt._jax_leaves(labels)):
        if lbl != "trainable":
            assert not torch.any(g)
            continue
        n_trained += 1
        scale = max(1e-12, float(w.abs().max()))
        np.testing.assert_allclose(g.numpy() / scale, w.numpy() / scale,
                                   atol=1e-4 if in_trunk else NC_GRAD_ATOL)
    # VGG: the conv's w and b; DenseNet: transition2's conv and BN affine;
    # and the NC stack's two layers
    assert n_trained == {"vgg": 2, "densenet201": 3}[name] + 4
