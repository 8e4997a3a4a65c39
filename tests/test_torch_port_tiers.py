"""The port's NC-stack tiers (``ncnet_tpu_torch/ops/conv4d_fft.py``,
``ops/conv4d_cp.py``, ``ops/cp_als.py``, ``ops/nc_fused_lane.py::
choose_fused_stack``) and the routing of ``models/ncnet.py::neigh_consensus``
against the JAX package on the CPU, on the same seeded numpy inputs.

Tolerances:
  * fp32 tiers and stacks: normalized atol 1e-4 (divided by the
    reference's max), tests/test_conv4d_tiers.py's own bound for the
    spectral and CP chains against the dense stack (FFT round-off);
    rank-full CP against dense conv4d: 1e-5;
  * bf16 stacks: normalized atol 3e-2, the JAX bf16 suite's bound (the
    two sides round the volume between layers at the same points but sum
    in different orders);
  * ``decompose_stack``: bitwise (the same numpy arithmetic);
  * the fp32 engine table: coordinates exact, scores and quality rtol
    1e-4, under centre-peaked NC kernels so every match is unambiguous.
Tier decisions must be equal to the JAX chooser's with ``pallas_ok=False``
(the JAX compile probes pass on the CPU; they are stubbed to True where a
grid would compile many programs).
"""

import importlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ncnet_tpu import config as jcfg
from ncnet_tpu.models import ncnet as jnet
from ncnet_tpu.serving.engine import BatchMatchEngine as JaxEngine
from ncnet_tpu_torch import config as tcfg
from ncnet_tpu_torch.models import ncnet as tnet
from ncnet_tpu_torch.models.convert import params_from_numpy
from ncnet_tpu_torch.ops import conv4d_cp as tcp
from ncnet_tpu_torch.ops import conv4d_fft as tfft
from ncnet_tpu_torch.ops import conv4d_pallas as tpallas
from ncnet_tpu_torch.ops import cp_als as tals
from ncnet_tpu_torch.ops import nc_fused_lane as tlane
from ncnet_tpu_torch.serving.engine import BatchMatchEngine

jcp = importlib.import_module("ncnet_tpu.ops.conv4d_cp")
jfft = importlib.import_module("ncnet_tpu.ops.conv4d_fft")
jals = importlib.import_module("ncnet_tpu.ops.cp_als")
jlane = importlib.import_module("ncnet_tpu.ops.nc_fused_lane")


def rng(seed=0):
    return np.random.default_rng(seed)


def normed_close(got, want, atol):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    scale = max(1e-6, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


def make_stack(seed, kernels, channels, scale=0.1):
    """A seeded stack as numpy arrays (normal weights, small biases)."""
    r = rng(seed)
    layers, c_in = [], 1
    for k, c_out in zip(kernels, channels):
        layers.append({
            "w": (r.normal(size=(k,) * 4 + (c_in, c_out)) * scale / np.sqrt(c_in)
                  ).astype(np.float32),
            "b": (r.normal(size=(c_out,)) * 0.1).astype(np.float32)})
        c_in = c_out
    return layers


def as_jax(layers, dtype=jnp.float32):
    return [jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), layer)
            for layer in layers]


def as_torch(layers, dtype=torch.float32):
    return [tnet.tree_map(lambda t: t.to(dtype), layer)
            for layer in params_from_numpy({"nc": layers})["nc"]]


@pytest.fixture
def fresh_chooser():
    """The JAX chooser with no cached decision or demotion, both sides'
    last decisions cleared (tests/test_conv4d_tiers.py's fixture)."""
    def clear():
        jlane.reset_fused_tier_demotions()
        jlane._emitted_choices.clear()
        jlane._last_selected.clear()
        tlane._last_selected.clear()

    clear()
    yield
    clear()


@pytest.fixture
def stub_probes(monkeypatch):
    monkeypatch.setattr(jfft, "fft_compiles", lambda *a: True)
    monkeypatch.setattr(jcp, "cp_compiles", lambda *a: True)


# ---------------------------------------------------------------------------
# the FFT tier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,k,c_in,c_out", [
    ((2, 5, 4, 6, 5), 3, 1, 4), ((1, 6, 6, 5, 7), 5, 3, 2), ((1, 4, 4, 4, 4), 1, 2, 2)])
def test_conv4d_fft_matches_jax(shape, k, c_in, c_out):
    x = rng(1).normal(size=shape + (c_in,)).astype(np.float32)
    w = (rng(2).normal(size=(k,) * 4 + (c_in, c_out)) * 0.2).astype(np.float32)
    b = rng(3).normal(size=(c_out,)).astype(np.float32)
    got = tfft.conv4d_fft(*(torch.from_numpy(a) for a in (x, w, b)))
    want = jfft.conv4d_fft(*(jnp.asarray(a) for a in (x, w, b)))
    assert got.dtype == torch.float32 and got.is_contiguous()
    normed_close(got, want, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nc_stack_fft_matches_jax(dtype):
    layers = make_stack(4, (5, 5), (4, 1))
    x = rng(5).normal(size=(2, 6, 5, 6, 7, 1)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    got = tfft.nc_stack_fft(as_torch(layers, td), torch.from_numpy(x).to(td))
    want = jfft.nc_stack_fft(as_jax(layers, jd), jnp.asarray(x).astype(jd))
    assert got.dtype == td
    normed_close(got, want, 1e-4 if dtype == "float32" else 3e-2)


def test_fft_stack_activations_end_in_nc_stack_fft():
    """One FFT layer loop: the activations the fused stack saves for B3 are
    the input and each layer's output, and the last is the tier's stack."""
    layers = as_torch(make_stack(4, (5, 3), (4, 1)))
    x = torch.from_numpy(rng(5).normal(size=(2, 6, 5, 6, 7, 1)).astype(np.float32))
    acts = tfft.fft_stack_activations(layers, x)
    assert len(acts) == 3 and acts[0] is x
    assert [a.shape[-1] for a in acts[1:]] == [4, 1]
    torch.testing.assert_close(acts[-1], tfft.nc_stack_fft(layers, x),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        acts[1], torch.relu(tfft.conv4d_fft(x, layers[0]["w"], layers[0]["b"])),
        rtol=0, atol=0)


def test_fused_stack_forward_refuses_a_stack_no_tier_takes(fresh_chooser):
    """``fused_stack_forward`` runs a tier or raises: a stack no tier takes
    is ``neigh_consensus``'s to run layer by layer."""
    layers = as_torch(make_stack(6, (3, 3), (4, 1)), torch.bfloat16)
    x = torch.zeros((1, 6, 6, 6, 6, 1), dtype=torch.bfloat16)
    assert tlane.choose_fused_stack(6, 6, 6, 6, (3, 3), (4, 1)) == "resident"
    assert tlane.fused_stack_forward(layers, x).shape == (1, 6, 6, 6, 6, 1)
    with pytest.raises(ValueError, match="no tier"):
        tlane.fused_stack_forward([{k: v.float() for k, v in p.items()}
                                 for p in layers], x.float())


def test_conv4d_fft_rejects_even_taps():
    with pytest.raises(ValueError, match="odd"):
        tfft.conv4d_fft(torch.zeros(1, 4, 4, 4, 4, 1), torch.zeros(2, 2, 2, 2, 1, 1))


SHAPES = [(4, 4, 4, 4), (6, 6, 6, 6), (8, 8, 8, 8), (13, 13, 13, 13), (25, 25, 25, 25),
          (50, 50, 50, 50), (25, 20, 30, 25), (60, 80, 60, 80)]
ARCHES = [((5, 5, 5), (16, 16, 1)), ((3, 3, 3), (16, 16, 1)), ((3, 3), (16, 1)),
          ((5, 5), (4, 1)), ((3, 3, 3), (10, 10, 1)), ((5, 5), (16, 2)), ((4, 4), (4, 1)),
          ((7, 7), (8, 1))]


def test_fft_gates_match_jax():
    for s, (kernels, channels) in itertools.product(SHAPES, ARCHES):
        assert tfft.fft_feasible(*s, kernels, channels) == jfft.fft_feasible(
            *s, kernels, channels), (s, kernels, channels)
        assert tfft.fft_spectrum_bytes(s, kernels, channels) == \
            jfft.fft_spectrum_bytes(s, kernels, channels)
        assert tfft.fft_layer_flops(s, kernels[0], 1, channels[0]) == \
            jfft.fft_layer_flops(s, kernels[0], 1, channels[0])
    assert tfft.fft_feasible(25, 25, 25, 25, (5, 5, 5), (16, 16, 1))


def test_cp_gate_matches_jax():
    for s, (kernels, channels), r in itertools.product(SHAPES, ARCHES, (1, 4, 16, 64, 400)):
        ranks = (r,) * len(kernels)
        assert tcp.cp_feasible(*s, kernels, channels, ranks) == jcp.cp_feasible(
            *s, kernels, channels, ranks), (s, kernels, channels, ranks)
    assert not tcp.cp_feasible(6, 6, 6, 6, (3,), (1,), (1, 1))  # rank count
    cells = 6 ** 4
    assert tcp.cp_layer_flops(cells, 5, 16, 16, 8) == jcp.cp_layer_flops(cells, 5, 16, 16, 8)
    assert tcp.dense_layer_flops(cells, 5, 16, 1) == jcp.dense_layer_flops(cells, 5, 16, 1)


# ---------------------------------------------------------------------------
# the CP tier
# ---------------------------------------------------------------------------


def test_exact_cp_factors_and_reconstruct_match_jax():
    w = (rng(6).normal(size=(3, 3, 3, 3, 2, 3))).astype(np.float32)
    got = tcp.exact_cp_factors(torch.from_numpy(w))
    want = jcp.exact_cp_factors(jnp.asarray(w))
    assert set(got) == set(want)
    for key in got:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    np.testing.assert_allclose(tcp.cp_reconstruct(got).numpy(),
                               np.asarray(jcp.cp_reconstruct(want)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tcp.cp_reconstruct(got).numpy(), w, rtol=0, atol=1e-6)


def test_nc_stack_cp_matches_jax_and_dense():
    """Rank-full (exact) factors: the CP chain equals JAX's chain and the
    dense stack; low-rank ALS factors: equal to JAX's chain."""
    layers = make_stack(7, (3, 3), (4, 1))
    x = rng(8).normal(size=(2, 5, 6, 5, 4, 1)).astype(np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    tl = as_torch(layers)
    exact = [{**layer, "cp": tcp.exact_cp_factors(layer["w"])} for layer in tl]
    got = tcp.nc_stack_cp(exact, tx)
    dense = tx
    for layer in tl:
        dense = torch.relu(tnet.conv4d(dense, layer["w"], layer["b"]))
    normed_close(got, dense.numpy(), 1e-5)
    jl = as_jax(layers)
    jexact = [{**layer, "cp": jcp.exact_cp_factors(layer["w"])} for layer in jl]
    normed_close(got, jcp.nc_stack_cp(jexact, jx), 1e-5)
    tlow, _ = tals.decompose_stack(tl, 3, iters=4)
    jlow, _ = jals.decompose_stack(jl, 3, iters=4)
    normed_close(tcp.nc_stack_cp(tlow, tx), jcp.nc_stack_cp(jlow, jx), 1e-5)
    assert tcp.cp_stack_ranks(tlow) == jcp.cp_stack_ranks(jlow) == (3, 3)
    assert tcp.cp_stack_ranks(tl) is None


def test_decompose_stack_bitwise_matches_jax():
    layers = make_stack(9, (3, 5), (3, 1))
    got, gerr = tals.decompose_stack(as_torch(layers), 4, iters=6)
    want, werr = jals.decompose_stack(as_jax(layers), 4, iters=6)
    assert gerr == werr
    for g, w in zip(got, want):
        assert set(g["cp"]) == set(w["cp"])
        for key in g["cp"]:
            assert g["cp"][key].dtype == torch.float32
            np.testing.assert_array_equal(g["cp"][key].numpy(), w["cp"][key])
    w0 = layers[0]["w"]
    for (gc, ge), (wc, we) in zip(tals.nested_decompose(w0, [1, 2, 4], iters=3),
                                  jals.nested_decompose(w0, [1, 2, 4], iters=3)):
        assert ge == we
        for key in gc:
            np.testing.assert_array_equal(gc[key].numpy(), wc[key])


# ---------------------------------------------------------------------------
# the chooser
# ---------------------------------------------------------------------------


def test_choose_fused_stack_matches_jax(fresh_chooser, stub_probes):
    for s, (kernels, channels), r in itertools.product(SHAPES, ARCHES, (None, 2, 16)):
        ranks = None if r is None else (r,) * len(kernels)
        want = jlane.choose_fused_stack(*s, kernels, channels, cp_ranks=ranks,
                                        pallas_ok=False)
        got = tlane.choose_fused_stack(*s, kernels, channels, cp_ranks=ranks,
                                       pallas_ok=False)
        assert got == want, (s, kernels, channels, ranks)
        assert tlane.last_selected_tier("forward") == jlane.last_selected_tier("forward")
    pf = ((5, 5, 5), (16, 16, 1))
    assert tlane.choose_fused_stack(25, 25, 25, 25, *pf, pallas_ok=False) == "fft"
    # bf16: the kernel tier where no arithmetic tier applies, never for a
    # wide final layer
    assert tlane.choose_fused_stack(50, 50, 50, 50, *pf) == "resident"
    assert tlane.choose_fused_stack(6, 6, 6, 6, *pf) == "resident"
    assert tlane.choose_fused_stack(6, 6, 6, 6, (3, 3), (16, 8)) is None
    assert tlane.choose_fused_stack(6, 6, 6, 6, (3, 5), (4, 1)) is None
    assert tlane.last_selected_tier("forward") == "xla"


def test_choose_fused_stack_fft_at_pf_pascal_real_probe(fresh_chooser):
    """The JAX decision at the PF-Pascal 25⁴ stack with its real compile
    probe: "fft", as the port decides."""
    pf = (25, 25, 25, 25, (5, 5, 5), (16, 16, 1))
    assert jlane.choose_fused_stack(*pf, pallas_ok=False) == "fft"
    assert tlane.choose_fused_stack(*pf, pallas_ok=False) == "fft"


# ---------------------------------------------------------------------------
# neigh_consensus routing
# ---------------------------------------------------------------------------


def nc_pair(seed, kernels, channels, shape, dtype="float32"):
    layers = make_stack(seed, kernels, channels)
    corr = rng(seed + 1).normal(0, 0.5, shape).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    return (as_jax(layers, jd), jnp.asarray(corr).astype(jd),
            as_torch(layers, td), torch.from_numpy(corr).to(td))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_neigh_consensus_selects_fft_naturally(fresh_chooser, dtype):
    """The k=5 16-channel arch at (1, 8, 8, 8, 8) takes the FFT tier in both
    packages and both dtypes (tests/test_conv4d_tiers.py:356-365); no B2
    launch, no twin of it."""
    jl, jc, tl, tc = nc_pair(12, (5, 5, 5), (16, 16, 1), (1, 8, 8, 8, 8), dtype)
    want = jnet.neigh_consensus(jl, jc, symmetric=False)
    assert jlane.last_selected_tier("forward") == "fft"
    before = tlane.launches
    got = tnet.neigh_consensus(tl, tc, symmetric=False)
    assert tlane.last_selected_tier("forward") == "fft"
    assert tlane.launches == before
    normed_close(got, want, 1e-4 if dtype == "float32" else 3e-2)


def test_force_tier_fft_and_cp(fresh_chooser):
    """k=3 fails both gates; forced, each tier runs anyway and is recorded
    (the symmetric square volume batch-folds)."""
    jl, jc, tl, tc = nc_pair(14, (3, 3), (4, 1), (2, 6, 6, 6, 6))
    for tier in ("fft", "cp"):
        if tier == "cp":
            jl = [{**layer, "cp": jcp.exact_cp_factors(layer["w"])} for layer in jl]
            tl = [{**layer, "cp": tcp.exact_cp_factors(layer["w"])} for layer in tl]
        want = jnet.neigh_consensus(jl, jc, force_tier=tier)
        assert jlane.last_selected_tier("forward") == tier
        got = tnet.neigh_consensus(tl, tc, force_tier=tier)
        assert tlane.last_selected_tier("forward") == tier
        normed_close(got, want, 1e-4)


def test_force_tier_cp_requires_factors_and_names_are_checked(fresh_chooser):
    jl, jc, tl, tc = nc_pair(16, (3,), (1,), (1, 5, 5, 5, 5))
    with pytest.raises(ValueError, match="CP factors"):
        jnet.neigh_consensus(jl, jc, force_tier="cp")
    with pytest.raises(ValueError, match="CP factors"):
        tnet.neigh_consensus(tl, tc, force_tier="cp")
    with pytest.raises(ValueError, match="force_tier"):
        tnet.neigh_consensus(tl, tc, force_tier="resident")


def test_neigh_consensus_selects_cp_naturally(fresh_chooser):
    """Rank-1 factors on a 1-channel k=3 stack pass the CP gate: both
    packages route "cp" with no force."""
    r = rng(18)
    layers = [{"w": None, "b": np.float32([0.05])}]
    fac = {k: r.normal(size=(3, 1)).astype(np.float32)
           for k in ("ka", "kwa", "kb", "kwb")}
    fac["cin"] = np.ones((1, 1), np.float32)
    fac["cout"] = r.normal(size=(1, 1)).astype(np.float32)
    layers[0]["w"] = np.asarray(jcp.cp_reconstruct({k: jnp.asarray(v) for k, v in fac.items()}))
    layers[0]["cp"] = fac
    corr = rng(19).normal(0, 0.5, (1, 7, 7, 7, 7)).astype(np.float32)
    want = jnet.neigh_consensus(as_jax(layers), jnp.asarray(corr), symmetric=False)
    assert jlane.last_selected_tier("forward") == "cp"
    got = tnet.neigh_consensus(as_torch(layers), torch.from_numpy(corr), symmetric=False)
    assert tlane.last_selected_tier("forward") == "cp"
    normed_close(got, want, 1e-5)


def spy_b5(monkeypatch):
    """Record the volume shape of every call of B5's twin."""
    calls = []
    real = tpallas.conv4d_small_cout_reference

    def spy(x, w):
        calls.append(tuple(x.shape))
        return real(x, w)

    monkeypatch.setattr(tpallas, "conv4d_small_cout_reference", spy)
    return calls


def test_fp32_per_layer_stack_goes_through_b5(fresh_chooser, monkeypatch):
    """An fp32 stack no tier takes (k=3 fails both gates) runs per layer:
    tapfold for 1→8, B5 (here its twin) for 8→1, once on the batch-folded
    square volume; the same values as the JAX per-layer stack."""
    calls = spy_b5(monkeypatch)
    jl, jc, tl, tc = nc_pair(20, (3, 3), (8, 1), (2, 6, 6, 6, 6))
    want = jnet.neigh_consensus(jl, jc)
    assert jlane.last_selected_tier("forward") == "xla"
    before = tpallas.launches
    got = tnet.neigh_consensus(tl, tc)
    assert tlane.last_selected_tier("forward") == "xla"
    assert calls == [(4, 6, 6, 6, 6, 8)] and tpallas.launches == before
    normed_close(got, want, 1e-5)


def test_fold_ok_split(fresh_chooser, monkeypatch):
    """Past the fold gate at the doubled batch, the symmetric square
    volume runs its two passes one after the other (``:607-624``), in both
    packages, with the same values."""
    calls = spy_b5(monkeypatch)
    jl, jc, tl, tc = nc_pair(22, (3, 3), (8, 1), (2, 6, 6, 6, 6))
    # layer 1 (1→8) keeps tapfold at batch 2 but not at 4
    limit = 2 * 6 ** 4 * 3 * 1 * 4
    tconv_mod = importlib.import_module("ncnet_tpu_torch.ops.conv4d")
    jconv_mod = importlib.import_module("ncnet_tpu.ops.conv4d")
    monkeypatch.setattr(tconv_mod, "_FOLD_BYTES_LIMIT", limit)
    monkeypatch.setattr(jconv_mod, "_FOLD_BYTES_LIMIT", limit)
    want = jnet.neigh_consensus(jl, jc)
    got = tnet.neigh_consensus(tl, tc)
    assert calls == [(2, 6, 6, 6, 6, 8)] * 2
    normed_close(got, want, 1e-5)
    calls.clear()
    monkeypatch.setattr(tconv_mod, "_FOLD_BYTES_LIMIT", 2 * limit)
    tnet.neigh_consensus(tl, tc)
    assert calls == [(4, 6, 6, 6, 6, 8)]


@pytest.mark.parametrize("knob", ["custom_grad", "remat_layers"])
def test_training_knobs_route_per_layer(fresh_chooser, monkeypatch, knob):
    """``custom_grad`` (``conv4d_same``) and ``remat_layers`` (a checkpoint
    per layer) take the stack off the tiers even where FFT would win (the
    8→1 layer goes to B5); the value and the weight gradients equal the
    JAX package's."""
    calls = spy_b5(monkeypatch)
    jl, jc, tl, tc = nc_pair(24, (5, 5, 5), (8, 8, 1), (1, 8, 8, 8, 8))
    assert tlane.choose_fused_stack(8, 8, 8, 8, (5, 5, 5), (8, 8, 1)) == "fft"
    kw = {knob: True}

    def jloss(params):
        return jnp.sum(jnet.neigh_consensus(params, jc, **kw) ** 2)

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(jl)
    leaves = [{k: v.clone().requires_grad_() for k, v in layer.items()} for layer in tl]
    got = (tnet.neigh_consensus(leaves, tc, **kw) ** 2).sum()
    got.backward()
    assert calls  # the 8→1 layer through B5's twin, forward at least
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for layer, jlayer in zip(leaves, jgrads):
        for k in ("w", "b"):
            normed_close(layer[k].grad, jlayer[k], 1e-4)


def test_bf16_allow_pallas_false_runs_the_formulations(fresh_chooser):
    jl, jc, tl, tc = nc_pair(26, (3, 3), (4, 1), (2, 5, 5, 5, 5), "bfloat16")
    before = tlane.launches
    got = tnet.neigh_consensus(tl, tc, allow_pallas=False)
    assert tlane.launches == before and got.dtype == torch.bfloat16
    normed_close(got, jnet.neigh_consensus(jl, jc, allow_pallas=False), 3e-2)


def test_nc_stack_fused_fft_forward_b3_backward(fresh_chooser):
    """The training stack at an FFT shape, (5, 5, 5) / (8, 8, 1) at 8⁴: the
    forward is the FFT tier's, as the JAX ``_fused_stack_impl``, and the
    backward is B3's twin on the saved FFT activations.

    The value against the JAX ``nc_stack_fused`` forward, to 3e-2
    normalized (the bf16 bound).  The gradients against the JAX VJP of the
    stack over the same bf16 values in f32 (``ref_vjp_f32``), to 6e-2: at 8
    channels B3's bf16 operands (activations, masked cotangent) leave the
    twin 5.27e-2 from it on the worst tensor (layer 1's dW), and 5.39e-2
    from the JAX Pallas VJP in interpret mode, measured alike with the B2
    twin's dense activations, so that bound measures B3's bf16 arithmetic,
    not the FFT forward.  The FFT forward's own effect is held tighter:
    against B3's twin on the B2 twin's activations, to 1e-2."""
    from test_torch_port_nc_vjp import as_jax as vjp_jax
    from test_torch_port_nc_vjp import as_torch as vjp_torch
    from test_torch_port_nc_vjp import margin_stack, ref_vjp_f32

    from ncnet_tpu_torch.ops import nc_fused_lane_vjp as tvjp

    layers, x, g = margin_stack(5, (1, 8, 8, 8, 8), (5, 5, 5), (8, 8, 1), 1e-3)
    jp, jx, _ = vjp_jax(layers, x, g)
    jy = jlane.nc_stack_fused(jp, jx)
    assert jlane.last_selected_tier("forward") == "fft"
    jd_params, jdx = ref_vjp_f32(layers, x, g)
    params, tx, tg = vjp_torch(layers, x, g, grad=True)
    before = tlane.launches
    ty = tlane.nc_stack_fused(params, tx)
    assert tlane.last_selected_tier("forward") == "fft"
    ty.backward(tg)
    assert tlane.launches == before
    normed_close(ty, jy, 3e-2)
    got = [layer[k].grad for layer in params for k in ("w", "b")] + [tx.grad]
    want = [jlayer[k] for jlayer in jd_params for k in ("w", "b")] + [jdx]
    for a, b in zip(got, want):
        normed_close(a, b, 6e-2)
    d_params, d_dx = tvjp.nc_stack_vjp_reference(*vjp_torch(layers, x, g))
    twin = [d[k] for d in d_params for k in ("w", "b")] + [d_dx]
    for a, b in zip(got, twin):
        normed_close(a, b.float().numpy(), 1e-2)


def test_nc_stack_fused_cp_forward(fresh_chooser):
    """Factors that pass the CP gate on the training stack: the value is the
    CP chain's (the JAX ``_fused_stack_impl``), the gradients are B3's twin
    on the dense stack's activations (the JAX backward replays the dense
    stack), bit for bit."""
    from ncnet_tpu_torch.ops import nc_fused_lane_vjp as tvjp

    r = rng(34)
    fac = {k: (r.normal(size=(3, 1)) * 0.5).astype(np.float32)
           for k in ("ka", "kwa", "kb", "kwb")}
    fac["cin"] = np.ones((1, 1), np.float32)
    fac["cout"] = np.ones((1, 1), np.float32)
    w = np.array(jcp.cp_reconstruct({k: jnp.asarray(v) for k, v in fac.items()}))
    layer = {"w": torch.from_numpy(w).to(torch.bfloat16),
             "b": torch.tensor([0.05]).to(torch.bfloat16),
             "cp": {k: torch.from_numpy(v) for k, v in fac.items()}}
    x = torch.from_numpy(rng(35).normal(0, 0.5, (1, 7, 7, 7, 7, 1)).astype(
        np.float32)).to(torch.bfloat16)
    params = [{**layer, "w": layer["w"].clone().requires_grad_(),
               "b": layer["b"].clone().requires_grad_()}]
    y = tlane.nc_stack_fused(params, x)
    assert tlane.last_selected_tier("forward") == "cp"
    torch.testing.assert_close(y, tcp.nc_stack_cp([layer], x), rtol=0, atol=0)
    g = torch.from_numpy(rng(36).normal(size=y.shape).astype(np.float32)).to(torch.bfloat16)
    y.backward(g)
    dense = [{"w": layer["w"], "b": layer["b"]}]
    d_params, _ = tvjp.nc_stack_vjp_reference(dense, x, g)
    torch.testing.assert_close(params[0]["w"].grad, d_params[0]["w"], rtol=0, atol=0)
    torch.testing.assert_close(params[0]["b"].grad, d_params[0]["b"], rtol=0, atol=0)


def test_engine_fp32_table_matches_jax(fresh_chooser, monkeypatch):
    """The fp32 serving path of the k=5 (16, 16, 1) arch at 96 px (a 6⁴
    volume, where the FFT gate fails): per layer, with the 16→1 layer
    through B5's twin; the engine's table equals the JAX engine's."""
    calls = spy_b5(monkeypatch)
    kw = dict(backbone="tiny", ncons_kernel_sizes=(5, 5, 5), ncons_channels=(16, 16, 1))
    jc, tc = jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)
    jp = jnet.init_ncnet(jc, jax.random.key(30))
    r = rng(31)
    nc = []
    for layer in jp["nc"]:
        w = r.normal(0, 0.01, layer["w"].shape).astype(np.float32)
        w[2, 2, 2, 2] += 1.0 / w.shape[4]
        nc.append({"w": jnp.asarray(w), "b": jnp.full(layer["b"].shape, 0.05, jnp.float32)})
    jp["nc"] = nc
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    src = r.integers(0, 256, (2, 96, 96, 3), dtype=np.uint8)
    tgt = np.stack([src[0], np.roll(src[1], (32, 32), axis=(0, 1))])
    jax_engine = JaxEngine(jc, jp)
    want = np.asarray(jax_engine.fetch(jax_engine.dispatch(src, tgt)))
    engine = BatchMatchEngine(tc, tp, device="cpu")
    got = engine.fetch(engine.dispatch(src, tgt))
    assert calls == [(4, 6, 6, 6, 6, 16)]
    assert tlane.last_selected_tier("forward") == "xla"
    assert got.shape == want.shape == (2, 6, 36)
    np.testing.assert_array_equal(got[:, :4], want[:, :4])
    np.testing.assert_allclose(got[:, 4:], want[:, 4:], rtol=1e-4, atol=1e-7)


def test_coarse2fine_forwards_nc_tier(fresh_chooser, monkeypatch):
    """``_sparse_dual_refine`` passes ``config.nc_tier`` to the tiles' stack,
    as the coarse pass does: every stack call of a coarse-to-fine forward
    is forced to the FFT tier."""
    tc = tcfg.ModelConfig(backbone="tiny", ncons_kernel_sizes=(3,),
                          ncons_channels=(1,), sparse_topk=2, nc_tier="fft")
    params = tnet.init_ncnet(tc, seed=0)
    r = rng(32)
    fa, fb = (torch.nn.functional.normalize(torch.from_numpy(
        r.normal(size=(1, 8, 8, 16)).astype(np.float32)), dim=-1) for _ in range(2))
    calls = []
    real = tnet.neigh_consensus

    def spy(*a, **k):
        calls.append(k.get("force_tier"))
        return real(*a, **k)

    monkeypatch.setattr(tnet, "neigh_consensus", spy)
    out = tnet.coarse2fine_filter(tc, params, fa, fb)
    assert out.corr.shape == (1, 8, 8, 8, 8)
    assert len(calls) == 3 and all(t == "fft" for t in calls)
    assert tlane.last_selected_tier("forward") == "fft"


# ---------------------------------------------------------------------------
# the compiled-shape gate of the kernel tier (ROADMAP §C, C1)
# ---------------------------------------------------------------------------


def spy_stack_routes(monkeypatch):
    """Record the kernel tier's entry points as ``neigh_consensus`` calls
    them (``fused_stack_forward``, ``nc_stack_fused``), each still run."""
    calls = []
    for name in ("fused_stack_forward", "nc_stack_fused"):
        fn = getattr(tlane, name)
        monkeypatch.setattr(tlane, name, lambda p, x, _fn=fn, _n=name: (
            calls.append(_n), _fn(p, x))[1])
    return calls


@pytest.mark.parametrize("kernels,channels,side", [
    ((5, 5, 5), (8, 8, 1), 6),     # 8 channels: no compiled layer shape
    ((7, 7, 7), (16, 16, 1), 50),  # k = 7: no compiled layer shape
])
def test_uncompiled_bf16_stacks_take_no_kernel_tier(fresh_chooser, kernels,
                                                     channels, side):
    """A bf16 stack of one odd k with a thin final layer is B2's shape
    class only where every layer is compiled into the kernels; any other
    stack is None ('xla') before any launch, where the JAX package falls
    to its XLA tier."""
    assert not tlane.stack_compiled(kernels, channels)
    assert not tlane.fused_shape_class(kernels, channels)
    assert tlane.choose_fused_stack(side, side, side, side, kernels, channels) is None
    assert tlane.last_selected_tier() == "xla"
    assert tlane.stack_compiled((5, 5, 5), (16, 16, 1))
    assert tlane.choose_fused_stack(side, side, side, side, (5, 5, 5),
                                    (16, 16, 1)) == "resident"
    assert tlane.last_selected_tier() == "resident"


@pytest.mark.parametrize("kernels,channels", [((5, 5, 5), (8, 8, 1)),
                                              ((7, 7, 7), (16, 16, 1))])
def test_uncompiled_bf16_stacks_route_per_layer(fresh_chooser, monkeypatch,
                                                kernels, channels):
    """Forward and the training gate (``require_vjp``) of an uncompiled
    bf16 stack on a 5⁴ volume: no kernel-tier entry point runs, the tier
    reads 'xla', and the value (and, in training, the gradients through
    the formulations) equals the per-layer route's with the kernel tier
    off."""
    calls = spy_stack_routes(monkeypatch)
    layers = as_torch(make_stack(31, kernels, channels), torch.bfloat16)
    x = torch.from_numpy(rng(32).uniform(0, 1, (1, 5, 5, 5, 5)).astype(
        np.float32)).to(torch.bfloat16)
    tlane.note_forced_tier("resident")
    plain = tnet.neigh_consensus(layers, x, allow_pallas=False)
    if tlane.choose_fused_stack(5, 5, 5, 5, kernels, channels) is None:
        got = tnet.neigh_consensus(layers, x)
        assert tlane.last_selected_tier() == "xla"
        assert torch.equal(got, plain)
    leaves = [{k: v.clone().requires_grad_() for k, v in p.items()} for p in layers]
    tlane.note_forced_tier("resident")
    out = tnet.neigh_consensus(leaves, x, require_vjp=True)
    assert tlane.last_selected_tier() == "xla"
    assert torch.equal(out.detach(), plain)
    out.float().square().sum().backward()
    ref = [{k: v.clone().requires_grad_() for k, v in p.items()} for p in layers]
    tnet.neigh_consensus(ref, x, allow_pallas=False).float().square().sum().backward()
    for a, b in zip(leaves, ref):
        assert torch.equal(a["w"].grad, b["w"].grad)
        assert torch.equal(a["b"].grad, b["b"].grad)
    assert calls == []


def test_compiled_bf16_stack_takes_the_kernel_tier(fresh_chooser, monkeypatch):
    """The compiled PF-Pascal stack at 6⁴ (no arithmetic tier): the
    forward takes 'resident' and the training gate the fused stack with
    the B3 backward (their twins here)."""
    calls = spy_stack_routes(monkeypatch)
    layers = as_torch(make_stack(33, (5, 5, 5), (16, 16, 1)), torch.bfloat16)
    x = torch.from_numpy(rng(34).uniform(0, 1, (1, 6, 6, 6, 6)).astype(
        np.float32)).to(torch.bfloat16)
    tnet.neigh_consensus(layers, x)
    assert tlane.last_selected_tier() == "resident"
    assert calls == ["fused_stack_forward"]
    leaves = [{k: v.clone().requires_grad_() for k, v in p.items()} for p in layers]
    tnet.neigh_consensus(leaves, x, require_vjp=True).float().sum().backward()
    assert calls[1:] == ["nc_stack_fused"]
    assert all(p["w"].grad is not None for p in leaves)
