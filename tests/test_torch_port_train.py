"""The port's training slice (``ncnet_tpu_torch/training/``) against the JAX
package on the CPU.

Both frameworks get the same weights (the JAX init, carried over by
``models/convert.py``) with the NC biases shifted off zero, as
tests/test_nc_vjp.py's ``_tiny_params`` does: a random-init net on a
mutual-matched volume otherwise sits at the ReLU boundary, where bf16
rounding decides the masks, and its scores are flat.  Images are seeded
numpy arrays; the trunk is ``tiny`` at 64 px (a 4⁴ volume).

Tolerances, each with its reason:
  * fp32 (the JAX package runs XLA's conv4d, the port ``F.conv3d``; only
    the summation order differs): the loss, a difference of two scores of
    ~0.06, to 1e-6 absolute (~1e-5 of a score); gradients and Adam moments
    to normalized atol 1e-4 (per tensor, divided by its max);
  * bf16 (the JAX side forced through its Pallas VJP in interpret mode,
    the port through its twin): the JAX forward rounds each per-tap dot to
    bf16 and the port's does not, and the volume, softmax, max and mean are
    bf16 on both sides.  On random-init weights and unrelated images the
    loss is ~1e-3, a few bf16 ulps of a score, and bf16 rounding alone moves
    the gradients by tens of percent (the port's bf16 against its own fp32,
    and JAX's Pallas VJP against JAX's XLA bf16 autodiff, alike).  So the
    bf16 test gives the pairs a signal: targets are the sources shifted by
    one feature cell, and the NC kernels are centre-peaked (centre tap 1
    plus N(0, 0.05)).  There the scores are ~0.3, whose bf16 ulp is 2⁻⁹,
    and the loss (their difference) agrees to 2⁻⁸ absolute, two such ulps;
    the NC gradients to normalized 5e-2 (2.8e-2 measured at the worst
    tensor);
  * params after a step: Adam's first update is ``−lr·g/(|g| + eps)``,
    ``±lr`` wherever ``|g| ≫ eps``, so a gradient that is zero up to
    rounding may take either sign: params agree to ``2·lr`` absolute at
    the worst cell and to 1e-6 on the cells whose gradient is above 1e-3
    of its tensor's max.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ncnet_tpu import config as jcfg
from ncnet_tpu import training as jtrain
from ncnet_tpu.models import backbone as jbb
from ncnet_tpu.models import ncnet as jnet
from ncnet_tpu.training import train as jtrain_mod
from ncnet_tpu_torch import config as tcfg
from ncnet_tpu_torch import training as ttrain
from ncnet_tpu_torch.models import backbone as tbb
from ncnet_tpu_torch.models.convert import params_from_numpy
from ncnet_tpu_torch.ops import nc_fused_lane, nc_fused_lane_vjp
from ncnet_tpu_torch.training import train as ttrain_mod

LR = 5e-4
KW = dict(backbone="tiny", ncons_kernel_sizes=(3, 3), ncons_channels=(4, 1))


def configs(**kw):
    return jcfg.ModelConfig(**{**KW, **kw}), tcfg.ModelConfig(**{**KW, **kw})


def shared_params(jc, seed=0):
    jp = jnet.init_ncnet(jc, jax.random.key(seed))
    jp["nc"] = [{"w": layer["w"], "b": layer["b"] + 0.05} for layer in jp["nc"]]
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def peaked_params(jc, seed=0):
    """JAX-initialized params with centre-peaked NC kernels (see the module
    docstring), as JAX params and port params."""
    jp = jnet.init_ncnet(jc, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    nc = []
    for layer in jp["nc"]:
        w = rng.normal(0, 0.05, layer["w"].shape).astype(np.float32)
        d = w.shape[0] // 2
        w[d, d, d, d] += 1.0 / w.shape[4]
        nc.append({"w": jnp.asarray(w), "b": jnp.asarray(
            rng.normal(0.05, 0.02, layer["b"].shape).astype(np.float32))})
    jp["nc"] = nc
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def shifted_batch(seed, b=2, hw=64):
    """Targets that are the sources rolled by one feature cell (16 px)."""
    src = np.random.default_rng(seed).uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32)
    return {"source_image": src,
            "target_image": np.roll(src, (16, 16), axis=(1, 2)).copy()}


def batch(seed, b=2, hw=64):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32)
            for k in ("source_image", "target_image")}


def assert_loss_close(got, want, atol=1e-6):
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=atol)


def jbatch(nb):
    return {k: jnp.asarray(v) for k, v in nb.items()}


def tbatch(nb):
    return {k: torch.from_numpy(v) for k, v in nb.items()}


def as_np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


def assert_normalized_close(got, want, atol):
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape
    scale = max(1e-12, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


def assert_nc_close(got, want, atol):
    for g_layer, w_layer in zip(got, want):
        for k in ("w", "b"):
            assert_normalized_close(g_layer[k], w_layer[k], atol)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("normalization", ["softmax", "l1", "none"])
def test_match_score_per_pair(dtype, normalization):
    """fp32: rtol 1e-5.  bf16: both sides round exp, the sums and the
    division to bf16 at the same points, so up to one bf16 ulp (2⁻⁸)."""
    vol = np.random.default_rng(0).uniform(0, 4, (2, 3, 4, 5, 3)).astype(np.float32)
    want = np.asarray(jtrain.match_score_per_pair(
        jnp.asarray(vol).astype(dtype), normalization), np.float32)
    got = ttrain.match_score_per_pair(
        torch.from_numpy(vol).to(getattr(torch, dtype)), normalization)
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_allclose(as_np(got), want,
                               rtol=1e-5 if dtype == "float32" else 2.0 ** -8)
    np.testing.assert_allclose(
        as_np(ttrain.match_score(torch.from_numpy(vol), normalization)),
        np.asarray(jtrain.match_score(jnp.asarray(vol), normalization)),
        rtol=1e-5)


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_auto_accum_chunks(n_dev):
    for b in range(1, 33):
        assert ttrain.auto_accum_chunks(b, n_dev) == jtrain.auto_accum_chunks(b, n_dev)


def test_weak_loss_fp32_value_and_grads():
    jc, tc = configs()
    jp, tp = shared_params(jc)
    nb = batch(1)
    kw = dict(stop_backbone_grad=True)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtrain.weak_loss(jc, p, jbatch(nb), **kw)))(jp)
    leaves = [{k: v.clone().requires_grad_() for k, v in layer.items()}
              for layer in tp["nc"]]
    tloss = ttrain.weak_loss(tc, {**tp, "nc": leaves}, tbatch(nb), **kw)
    tloss.backward()
    assert abs(float(jloss)) > 1e-4  # a loss worth comparing
    assert_loss_close(tloss.detach(), jloss)
    assert_nc_close([{k: v.grad for k, v in layer.items()} for layer in leaves],
                    jgrads["nc"], 1e-4)


@pytest.mark.parametrize("fold", [False, True])
def test_weak_loss_fold_and_no_remat_agree(fold):
    """``fold_pos_neg`` and ``remat_filter`` change the program, not the
    value (fp32, against the JAX default form)."""
    jc, tc = configs()
    jp, tp = shared_params(jc)
    nb = batch(2)
    want = jtrain.make_eval_step(jc)(jp, jbatch(nb))
    got = ttrain.weak_loss(tc, tp, tbatch(nb), fold_pos_neg=fold,
                           remat_filter=not fold)
    assert_loss_close(got, want)


@pytest.mark.parametrize("chunks", [1, 2, -1])
def test_weak_loss_and_grads_fp32(chunks):
    jc, tc = configs()
    jp, tp = shared_params(jc)
    nb = batch(3)
    jloss, jg = jax.jit(lambda p, b: jtrain.weak_loss_and_grads(
        jc, p, b, accum_chunks=chunks))(jp, jbatch(nb))
    tloss, tg = ttrain.weak_loss_and_grads(tc, tp, tbatch(nb), accum_chunks=chunks)
    assert_loss_close(tloss, jloss)
    assert_nc_close(tg["nc"], jg["nc"], 1e-4)
    assert all(g.dtype == torch.float32 for layer in tg["nc"] for g in layer.values())
    # zero gradients for the detached trunk, in the params' tree
    zeros = ttrain_mod.tree_leaves(tg["backbone"])
    assert len(zeros) == len(jax.tree.leaves(jg["backbone"]))
    assert all(not z.any() for z in zeros)


@pytest.mark.parametrize("chunked", [False, True])
def test_bf16_against_pallas_vjp(monkeypatch, chunked):
    """The bf16 loss and NC gradients, whole-batch (``weak_loss`` under
    autodiff) and chunked (``weak_loss_and_grads``): the JAX side runs its
    resident Pallas VJP (interpret mode, forced as tests/test_nc_vjp.py
    forces it), the port its twin, and no kernel launches on the CPU."""
    monkeypatch.setenv("NCNET_FUSED_VJP_FORCE", "interpret")
    jc, tc = configs(half_precision=True)
    jp, tp = peaked_params(jc)
    nb = shifted_batch(4)
    before = (nc_fused_lane.launches, dict(nc_fused_lane_vjp.launches))
    if chunked:
        jloss, jg = jax.jit(lambda p, b: jtrain.weak_loss_and_grads(
            jc, p, b, accum_chunks=2))(jp, jbatch(nb))
        tloss, tg = ttrain.weak_loss_and_grads(tc, tp, tbatch(nb), accum_chunks=2)
        tg = tg["nc"]
    else:
        jloss, jg = jax.jit(jax.value_and_grad(lambda p, b: jtrain.weak_loss(
            jc, p, b, stop_backbone_grad=True)))(jp, jbatch(nb))
        leaves = [{k: v.clone().requires_grad_() for k, v in layer.items()}
                  for layer in tp["nc"]]
        tloss = ttrain.weak_loss(tc, {**tp, "nc": leaves}, tbatch(nb),
                                 stop_backbone_grad=True)
        tloss.backward()
        tloss = tloss.detach()
        tg = [{k: v.grad for k, v in layer.items()} for layer in leaves]
    assert (nc_fused_lane.launches, nc_fused_lane_vjp.launches) == before
    assert float(jloss) < -0.05  # the shifted pairs score well above the rolled ones
    assert_loss_close(tloss, jloss, atol=2.0 ** -8)
    assert_nc_close(tg, jg["nc"], 5e-2)


@pytest.mark.parametrize("half", [False, True])
def test_accum_chunks_give_the_same_gradients(half):
    """The whole-batch backward (``accum_chunks=0``) and the chunked ones
    (2, auto) agree: chunking reassociates only the f32 sum of the chunks."""
    _, tc = configs(half_precision=half)
    _, tp = shared_params(configs()[0])
    nb = tbatch(batch(5, b=4))
    leaves = [{k: v.clone().requires_grad_() for k, v in layer.items()}
              for layer in tp["nc"]]
    loss0 = ttrain.weak_loss(tc, {**tp, "nc": leaves}, nb, stop_backbone_grad=True)
    loss0.backward()
    g0 = [{k: v.grad for k, v in layer.items()} for layer in leaves]
    for chunks in (2, -1):
        loss, g = ttrain.weak_loss_and_grads(tc, tp, nb, accum_chunks=chunks)
        assert_loss_close(loss, loss0.detach(), 1e-6 if not half else 1e-3)
        assert_nc_close(g["nc"], g0, 1e-4 if not half else 1e-2)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def jax_adam(state):
    return state.opt_state.inner_states["trainable"].inner_state[0]


def port_state(jstate, tc, tp):
    labels = ttrain.trainable_labels(tc, tp)
    opt = ttrain.make_optimizer(labels)(LR)
    return ttrain.TrainState(tp, opt.init(tp), int(jstate.step)), opt


@pytest.fixture(scope="module")
def jax_steps():
    """Two JAX train steps (fp32, frozen trunk, auto chunks, NaN guard) on
    the shared params, and the states before and after each."""
    jc, tc = configs()
    jstate, jopt, jmc, _ = jtrain.create_train_state(jcfg.TrainConfig(
        model=jc, batch_size=2, lr=LR, data_parallel=False))
    jp, tp = shared_params(jc)
    jstate = jstate._replace(params=jp)
    step = jtrain.make_train_step(jmc, jopt, donate=False,
                                  stop_backbone_grad=True, accum_chunks=-1,
                                  nan_guard=True, with_grad_norm=True)
    states, losses, norms = [jstate], [], []
    for seed in (6, 7):
        s, loss, norm = step(states[-1], jbatch(batch(seed)))
        states.append(s)
        losses.append(float(loss))
        norms.append(float(norm))
    return tc, tp, states, losses, norms


def assert_params_close(got, want, grad):
    """See the module docstring: ``2·lr`` at worst, 1e-6 where the
    gradient is well above rounding."""
    got, want, grad = as_np(got), as_np(want), np.abs(as_np(grad))
    np.testing.assert_allclose(got, want, atol=2 * LR + 1e-6)
    big = grad > 1e-3 * grad.max()
    np.testing.assert_allclose(got[big], want[big], atol=1e-6)


def test_train_step_matches_jax(jax_steps):
    """One and two full steps: loss, NC params, Adam ``mu``/``nu``/``count``,
    the grad norm, the step counter; the frozen trunk untouched."""
    tc, tp, jstates, jlosses, jnorms = jax_steps
    state, opt = port_state(jstates[0], tc, tp)
    step = ttrain.make_train_step(tc, opt, stop_backbone_grad=True,
                                  accum_chunks=-1, nan_guard=True,
                                  with_grad_norm=True)
    for i, seed in enumerate((6, 7)):
        new, loss, norm = step(state, batch(seed))
        js, ja = jstates[i + 1], jax_adam(jstates[i + 1])
        assert_loss_close(loss, jlosses[i])
        np.testing.assert_allclose(float(norm), jnorms[i], rtol=1e-4)
        assert new.step == int(js.step) == i + 1
        assert int(new.opt_state.count) == int(ja.count) == i + 1
        for l, layer in enumerate(new.params["nc"]):
            for k in ("w", "b"):
                assert_normalized_close(new.opt_state.mu["nc"][l][k],
                                        ja.mu["nc"][l][k], 1e-4)
                assert_normalized_close(new.opt_state.nu["nc"][l][k],
                                        ja.nu["nc"][l][k], 1e-4)
                assert_params_close(layer[k], js.params["nc"][l][k],
                                    ja.mu["nc"][l][k])
        assert all(a is b for a, b in zip(
            ttrain_mod.tree_leaves(new.params["backbone"]),
            ttrain_mod.tree_leaves(state.params["backbone"])))
        assert new.opt_state.mu["backbone"]["conv1"]["w"] is None
        state = new


def test_nan_guard_keeps_the_state(jax_steps):
    """A NaN batch: params and Adam state unchanged, ``step`` advanced,
    the loss reported as NaN (the JAX step does the same)."""
    tc, tp, jstates, _, _ = jax_steps
    state, opt = port_state(jstates[0], tc, tp)
    step = ttrain.make_train_step(tc, opt, stop_backbone_grad=True,
                                  accum_chunks=-1, nan_guard=True)
    state, _ = step(state, batch(6))
    bad = batch(8)
    bad["source_image"][0, 0, 0, 0] = np.nan
    new, loss = step(state, bad)
    assert np.isnan(float(loss)) and new.step == state.step + 1
    assert new.params is state.params and new.opt_state is state.opt_state
    jstate = jstates[1]
    jnew, jloss = jtrain.make_train_step(
        configs()[0], jtrain.make_optimizer(jtrain.trainable_labels(
            configs()[0], jstate.params))(LR), donate=False,
        stop_backbone_grad=True, accum_chunks=-1, nan_guard=True)(
            jstate, jbatch(bad))
    assert np.isnan(float(jloss)) and int(jnew.step) == 2
    jax.tree.map(np.testing.assert_array_equal, jnew.params, jstate.params)


def test_process_epoch_excludes_nan_from_the_mean(jax_steps):
    """Train mode leaves guarded-away (NaN) steps out of the epoch mean, as
    the JAX loop does; eval mode keeps a NaN."""
    tc, tp, jstates, _, _ = jax_steps
    state, opt = port_state(jstates[0], tc, tp)
    step = ttrain.make_train_step(tc, opt, stop_backbone_grad=True,
                                  accum_chunks=-1, nan_guard=True)
    bad = batch(8)
    bad["target_image"][1, 2, 3, 1] = np.nan
    loader = [batch(6), bad, batch(7)]
    new, mean = ttrain.process_epoch("train", 1, state, step, loader)
    assert new.step == 3 and np.isfinite(mean)
    _, jmean = jtrain_mod.process_epoch(
        "train", 1, jstates[0],
        jtrain.make_train_step(configs()[0], jtrain.make_optimizer(
            jtrain.trainable_labels(configs()[0], jstates[0].params))(LR),
            donate=False, stop_backbone_grad=True, accum_chunks=-1,
            nan_guard=True),
        [jbatch(b) for b in loader])
    assert_loss_close(mean, jmean)
    _, emean = ttrain.process_epoch("eval", 1, new, ttrain.make_eval_step(tc),
                                    loader)
    assert np.isnan(emean)


def test_eval_step_matches_jax():
    jc, tc = configs()
    jp, tp = shared_params(jc)
    nb = batch(9)
    assert_loss_close(ttrain.make_eval_step(tc)(tp, nb),
                      jtrain.make_eval_step(jc)(jp, jbatch(nb)))


# ---------------------------------------------------------------------------
# configuration, state, labels
# ---------------------------------------------------------------------------


def test_train_config_mirrors_jax():
    jf = {f.name: f.default for f in dataclasses.fields(jcfg.TrainConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tcfg.TrainConfig)}
    assert list(tf) == list(jf)
    for name, default in jf.items():
        if name == "model":
            assert dataclasses.asdict(tf[name]) == dataclasses.asdict(default)
        else:
            assert tf[name] == default, name


@pytest.mark.parametrize("option,value", [
    ("fe_finetune_params", 1), ("finetune_cp_rank", 4),
    ("remat_nc_layers", True), ("nc_custom_grad", True),
    ("nc_pallas_vjp", False), ("distributed", True)])
def test_unported_train_options_raise(option, value):
    cfg = tcfg.TrainConfig(model=tcfg.ModelConfig(**KW), **{option: value})
    with pytest.raises(NotImplementedError, match=option):
        ttrain.create_train_state(cfg, device="cpu")


def test_create_train_state_cpu_and_default_device():
    cfg = tcfg.TrainConfig(model=tcfg.ModelConfig(**KW), batch_size=2)
    state, opt, mc, labels = ttrain.create_train_state(cfg, seed=3, device="cpu")
    assert state.step == 0 and mc == cfg.model
    assert labels["nc"] == [{"w": "trainable", "b": "trainable"}] * 2
    assert int(state.opt_state.count) == 0
    assert all(not m.any() for m in ttrain_mod.tree_leaves(state.opt_state.mu))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ttrain.create_train_state(cfg)


@pytest.mark.parametrize("name,n", [("resnet101", 0), ("resnet101", 2),
                                    ("tiny", 0), ("tiny", 1)])
def test_finetune_labels_match_jax(name, n):
    params = tbb.backbone_init(name, torch.Generator().manual_seed(0))
    tree = ttrain_mod.tree_map(lambda t: t.numpy(), params)
    assert tbb.finetune_labels(name, params, n) == jbb.finetune_labels(name, tree, n)


def test_unported_loss_knobs_raise():
    """The NC-stack knobs of the loss, once refused, now run as the JAX
    package runs them: ``remat_nc_layers`` and ``nc_custom_grad`` (fp32,
    value and NC gradients at the fp32 tolerances) and ``nc_pallas_vjp=False``
    (bf16 through the conv4d formulations, the bf16 loss tolerance)."""
    jc, tc = configs()
    jp, tp = shared_params(jc)
    nb = batch(0)
    for knob in (dict(remat_nc_layers=True), dict(nc_custom_grad=True)):
        kw = dict(stop_backbone_grad=True, **knob)
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p: jtrain.weak_loss(jc, p, jbatch(nb), **kw)))(jp)
        leaves = [{k: v.clone().requires_grad_() for k, v in layer.items()}
                  for layer in tp["nc"]]
        tloss = ttrain.weak_loss(tc, {**tp, "nc": leaves}, tbatch(nb), **kw)
        tloss.backward()
        assert_loss_close(tloss.detach(), jloss)
        assert_nc_close([{k: v.grad for k, v in layer.items()}
                         for layer in leaves], jgrads["nc"], 1e-4)
    jc, tc = configs(half_precision=True)
    jp, tp = peaked_params(jc)
    nb = shifted_batch(0)
    want = jtrain.weak_loss(jc, jp, jbatch(nb), nc_pallas_vjp=False)
    before = nc_fused_lane.launches
    got = ttrain.weak_loss(tc, tp, tbatch(nb), nc_pallas_vjp=False)
    assert nc_fused_lane.launches == before
    assert_loss_close(got.float(), want, atol=2.0 ** -8)
