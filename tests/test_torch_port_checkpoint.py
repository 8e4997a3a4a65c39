"""The port's native checkpoints (``ncnet_tpu_torch/models/checkpoint.py``,
ROADMAP decision D5) and training checkpoints against the JAX package's on
the CPU.

Both packages get the same weights: the JAX init, carried into the port by
``models/convert.py``, saved by each package's own ``save_params`` /
``save_train_checkpoint``.  What is compared, exactly (no tolerance: the
same bytes in, the same bytes or names out):

  * C2: ``TrainConfig.model.checkpoint`` loads in ``create_train_state``
    (a reference ``.pth.tar``): the port's params equal the file's weights
    and the JAX package's ``create_train_state`` on the same file;
  * ``params_payload_sha256``: the JAX digest of the same weights (tiny,
    ResNet-101; fp32, bf16 leaves, CP factor dicts);
  * the version names, the resolver, ``.tmp``/``.old`` handling and
    retention after the same sequence of saves, and ``config.json`` key for
    key;
  * ``tools/cp_decompose.py``'s factors (the same numpy ALS).
"""

import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ncnet_tpu import config as jcfg
from ncnet_tpu import training as jtrain
from ncnet_tpu.models import checkpoint as jckpt
from ncnet_tpu.models import ncnet as jnet
from ncnet_tpu.ops import cp_als as jals
from ncnet_tpu_torch import config as tcfg
from ncnet_tpu_torch import training as ttrain
from ncnet_tpu_torch.models import checkpoint as tckpt
from ncnet_tpu_torch.models.convert import params_from_numpy
from ncnet_tpu_torch.models.ncnet import NCNet
from ncnet_tpu_torch.tools import cp_decompose as tcp_tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(backbone="tiny", ncons_kernel_sizes=(3, 3), ncons_channels=(4, 1))
RESNET = dict(backbone="resnet101", ncons_kernel_sizes=(3, 3),
              ncons_channels=(4, 1))


def shared(kw, seed=0):
    """JAX-initialized params as (JAX numpy tree, port tree)."""
    jp = jax.tree.map(np.asarray, jnet.init_ncnet(jcfg.ModelConfig(**kw),
                                                  jax.random.key(seed)))
    return jp, params_from_numpy(jp)


@pytest.fixture(scope="module")
def resnet_params():
    return shared(RESNET, seed=3)


def assert_port_equals_jax(tp, jp):
    """The port tree equals the JAX tree leaf for leaf, bit for bit (trunk
    convs compared in the JAX layout)."""
    assert_trees_equal(tp, params_from_numpy(jax.tree.map(np.asarray, jp)))


def assert_trees_equal(got, want):
    """Two port trees equal key for key (in any insertion order) and bit
    for bit."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_trees_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert_trees_equal(a, b)
    elif want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype and torch.equal(got.cpu(), want.cpu())


# ---------------------------------------------------------------------------
# C2: the trainer's model.checkpoint
# ---------------------------------------------------------------------------


def test_create_train_state_loads_model_checkpoint(resnet_params, tmp_path):
    """C2: a reference ``.pth.tar`` in ``model.checkpoint`` is what the
    port trains from, as the JAX ``create_train_state`` does (the port
    once drew a random init and ignored it)."""
    jp, tp = resnet_params
    path = str(tmp_path / "ncnet_pfpascal.pth.tar")
    args = argparse.Namespace(ncons_kernel_sizes=[3, 3], ncons_channels=[4, 1],
                              feature_extraction_cnn="resnet101")
    torch.save({"epoch": 1, "args": args, "state_dict":
                tckpt.reference_state_dict(tcfg.ModelConfig(**RESNET), tp)},
               path)
    # the default ModelConfig's arch (10, 10, 1) is overridden by the file's
    tstate, _, tmc, _ = ttrain.create_train_state(
        tcfg.TrainConfig(model=tcfg.ModelConfig(checkpoint=path)), seed=9,
        device="cpu")
    jstate, _, jmc, _ = jtrain.create_train_state(
        jcfg.TrainConfig(model=jcfg.ModelConfig(checkpoint=path)))
    assert tuple(tmc.ncons_channels) == tuple(jmc.ncons_channels) == (4, 1)
    assert_port_equals_jax(tstate.params, jp)
    assert_port_equals_jax(tstate.params, jstate.params)


def test_native_directories_load_for_every_ported_trunk(tmp_path):
    """``check_ported`` narrowed: a native directory loads for ``tiny`` too
    (only the ``.pth.tar`` importer stays ResNet-101-only); the stored
    architecture overrides the caller's, the runtime flags stay."""
    jp, tp = shared(TINY)
    path = str(tmp_path / "ck")
    tckpt.save_params(path, tcfg.ModelConfig(**TINY), tp)
    net = NCNet(tcfg.ModelConfig(checkpoint=path, half_precision=True),
                device="cpu")
    assert net.config.backbone == "tiny" and net.config.half_precision
    assert_port_equals_jax(net.params, jp)
    with pytest.raises(NotImplementedError, match="checkpoint"):
        NCNet(tcfg.ModelConfig(backbone="tiny", checkpoint=path + ".pth.tar"),
              device="cpu")
    with pytest.raises(FileNotFoundError):  # a mistyped path is not found
        NCNet(tcfg.ModelConfig(backbone="tiny", checkpoint=path + "x"),
              device="cpu")


# ---------------------------------------------------------------------------
# the payload digest
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,cast", [(TINY, None), (TINY, "bf16"),
                                     (TINY, "cp"), (RESNET, None),
                                     (RESNET, "bf16")])
def test_payload_sha_equals_jax(kw, cast, resnet_params):
    jp, tp = resnet_params if kw is RESNET else shared(TINY)
    if cast == "bf16":
        jp = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), jp)
        tp = params_from_numpy(jp)
        assert tp["nc"][0]["w"].dtype == torch.bfloat16
    if cast == "cp":
        jp = dict(jp)
        jp["nc"], _ = jals.decompose_stack(jp["nc"], 2, iters=3)
        jp = jax.tree.map(np.asarray, jp)
        tp = params_from_numpy(jp)
        assert set(tp["nc"][1]["cp"]) == {"ka", "kwa", "kb", "kwb", "cin", "cout"}
    assert tckpt.params_payload_sha256(tp) == jckpt.params_payload_sha256(jp)
    # and it is the identity: one flipped weight changes it
    tp["nc"][0]["b"] = tp["nc"][0]["b"].clone()
    tp["nc"][0]["b"][0] += 1
    assert tckpt.params_payload_sha256(tp) != jckpt.params_payload_sha256(jp)


def test_save_load_roundtrip_and_verify(tmp_path):
    """``save_params``/``load_params`` round-trip bit for bit; the recorded
    digest is the JAX package's ``save_params``'s for the same weights; a
    torn payload fails verification."""
    jp, tp = shared(TINY, seed=5)
    cfg = tcfg.ModelConfig(**TINY)
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    tckpt.save_params(tdir, cfg, tp)
    jckpt.save_params(jdir, jcfg.ModelConfig(**TINY), jp)
    with open(os.path.join(tdir, "config.json")) as f:
        tdoc = json.load(f)
    with open(os.path.join(jdir, "config.json")) as f:
        jdoc = json.load(f)
    assert tdoc == jdoc
    _, back = tckpt.load_params(tdir)
    assert_port_equals_jax(back, jp)
    assert tckpt.verify_checkpoint_payload(tdir, back) == tdoc["_payload_sha256"]
    back["nc"][1]["w"][0, 0, 0, 0, 0, 0] += 1e-3
    with pytest.raises(tckpt.CheckpointPayloadError):
        tckpt.verify_checkpoint_payload(tdir, back)
    # a JAX-written (orbax) directory is refused by name, not misread
    with pytest.raises(ValueError, match="orbax"):
        tckpt.load_params(jdir)


# ---------------------------------------------------------------------------
# versioned roots: the same sequence of saves in both packages
# ---------------------------------------------------------------------------


def _states(tmp_path):
    jcfg_ = jcfg.TrainConfig(model=jcfg.ModelConfig(**TINY), batch_size=2,
                             result_model_dir=str(tmp_path), data_parallel=False)
    tcfg_ = tcfg.TrainConfig(model=tcfg.ModelConfig(**TINY), batch_size=2,
                             result_model_dir=str(tmp_path), data_parallel=False)
    jstate, _, jmc, _ = jtrain.create_train_state(jcfg_)
    tstate, _, tmc, _ = ttrain.create_train_state(tcfg_, device="cpu")
    jnp_params = jax.tree.map(np.asarray, jstate.params)
    tstate = tstate._replace(params=params_from_numpy(jnp_params))
    return (jcfg_, jmc, jstate), (tcfg_, tmc, tstate)


def _names(versions):
    return [(n, os.path.basename(p)) for n, p in versions]


def test_version_sequence_matches_jax(tmp_path):
    """Saves at steps 1, 2, 2 (a same-step re-save), 3, 4 with ``keep=3``,
    ``is_best`` at step 2, a ``.tmp`` carcass and a stranded ``.old``: the
    versions, the resolved version, ownership, the ``best_`` copy and each
    ``config.json`` (key for key, payload sha included) agree."""
    (jc, jmc, js), (tc, tmc, ts) = _states(tmp_path)
    train, test = np.array([0.5, np.nan]), np.array([0.25, 0.0])
    roots = {}
    for pkg, save, cfg, mc, state in (
            ("j", jtrain.save_train_checkpoint, jc, jmc, js),
            ("t", ttrain.save_train_checkpoint, tc, tmc, ts)):
        root = str(tmp_path / pkg / "run")
        for n, best in ((1, False), (2, True), (2, False), (3, False),
                        (4, False)):
            save(root, cfg, mc, state, 1, train, test, best, step=n,
                 position={"epoch": 1, "next_batch": n}, keep=3,
                 io_retries=1)
        roots[pkg] = root
    for pkg, ck in (("j", jckpt), ("t", tckpt)):
        root = roots[pkg]
        assert _names(ck.list_checkpoint_versions(root)) == [
            (2, "step_00000002"), (3, "step_00000003"), (4, "step_00000004")]
        assert os.path.isdir(os.path.join(os.path.dirname(root), "best_run"))
        # a crash mid-save of 5 and a stranded .old of 4 (its replacement
        # never committed): the carcass is skipped, the .old stands in
        os.makedirs(os.path.join(root, "step_00000005.tmp"))
        os.rename(os.path.join(root, "step_00000004"),
                  os.path.join(root, "step_00000004.old"))
        assert os.path.basename(ck.resolve_checkpoint_dir(root)) \
            == "step_00000004.old"
        assert ck.owning_checkpoint_root(
            os.path.join(root, "step_00000004.old")) == os.path.abspath(root)
    docs = {}
    for pkg in roots:
        with open(os.path.join(roots[pkg], "step_00000003", "config.json")) as f:
            docs[pkg] = json.load(f)
    # the configs name the same result_model_dir, so no path differs
    assert list(docs["t"]) == list(docs["j"])
    assert docs["t"] == docs["j"]
    assert docs["t"]["_train_loss"] == [0.5, None]
    # the next save reclaims the carcass and restores the .old in both
    for pkg, save, cfg, mc, state, ck in (
            ("j", jtrain.save_train_checkpoint, jc, jmc, js, jckpt),
            ("t", ttrain.save_train_checkpoint, tc, tmc, ts, tckpt)):
        save(roots[pkg], cfg, mc, state, 1, train, test, False, step=6,
             keep=3, io_retries=1)
        assert sorted(os.listdir(roots[pkg])) == [
            "step_00000003", "step_00000004", "step_00000006"]


def test_resume_refuses_a_torn_payload_and_roundtrips(tmp_path):
    """``load_train_checkpoint`` returns the saved state bit for bit, and
    refuses params that no longer hash to the recorded sha."""
    (_, _, _), (tc, tmc, ts) = _states(tmp_path)
    opt = ttrain.make_optimizer(ttrain.trainable_labels(tmc, ts.params))(1e-3)
    step = ttrain.make_train_step(tmc, opt, stop_backbone_grad=True,
                                  accum_chunks=-1, nan_guard=True)
    rng = np.random.default_rng(0)
    state, _ = step(ts, {k: rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
                         for k in ("source_image", "target_image")})
    root = str(tmp_path / "run")
    final = ttrain.save_train_checkpoint(
        root, tc, tmc, state, 0, np.zeros(1), np.zeros(1), False,
        position={"epoch": 1, "next_batch": 1})
    back, epoch, _, _, position = ttrain.load_train_checkpoint(root, ts)
    assert back.step == 1 and epoch == 0
    assert position == {"epoch": 1, "next_batch": 1}
    assert_trees_equal((back.params, back.opt_state._asdict()),
                       (state.params, state.opt_state._asdict()))
    torn = tckpt.load_tree(final, tckpt.PARAMS_FILE)
    torn["nc"][0]["b"][0] += 1
    torch.save(torn, os.path.join(final, tckpt.PARAMS_FILE))
    with pytest.raises(tckpt.CheckpointPayloadError):
        ttrain.load_train_checkpoint(root, ts)


def test_with_io_retries_bounded():
    calls = []

    def flaky(fail_n):
        def fn():
            calls.append(1)
            if len(calls) <= fail_n:
                raise OSError("transient")
            return 7
        return fn

    assert tckpt.with_io_retries(flaky(2), attempts=3, backoff=0.0) == 7
    assert len(calls) == 3
    calls.clear()
    with pytest.raises(OSError, match="transient"):
        tckpt.with_io_retries(flaky(5), attempts=2, backoff=0.0)
    assert len(calls) == 2


def test_resolver_rejects_root_with_only_tmp_carcasses(tmp_path):
    (tmp_path / "root" / "step_00000003.tmp").mkdir(parents=True)
    for ck in (tckpt, jckpt):
        with pytest.raises(FileNotFoundError, match="incomplete"):
            ck.resolve_checkpoint_dir(str(tmp_path / "root"))


# ---------------------------------------------------------------------------
# tools/cp_decompose.py
# ---------------------------------------------------------------------------


def test_cp_decompose_tool_matches_the_root_tool(tmp_path, capsys, monkeypatch):
    """The port's tool and the root tool give the same factors and errors
    for the same weights (each reading its own package's checkpoint)."""
    jp, tp = shared(TINY, seed=2)
    tin, jin = str(tmp_path / "t_in"), str(tmp_path / "j_in")
    tckpt.save_params(tin, tcfg.ModelConfig(**TINY), tp)
    jckpt.save_params(jin, jcfg.ModelConfig(**TINY), jp)
    monkeypatch.syspath_prepend(os.path.join(REPO, "tools"))
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "root_cp_decompose", os.path.join(REPO, "tools", "cp_decompose.py"))
    root_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root_tool)
    args = ["--rank", "2", "--iters", "4", "--json"]
    assert root_tool.main(["--checkpoint", jin, "--out",
                           str(tmp_path / "j_out")] + args) == 0
    jsum = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tcp_tool.main(["--checkpoint", tin, "--out",
                          str(tmp_path / "t_out")] + args) == 0
    tsum = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tsum["rel_errs"] == jsum["rel_errs"]
    _, jout = jckpt.load_params(str(tmp_path / "j_out"))
    _, tout = tckpt.load_params(str(tmp_path / "t_out"))
    assert_port_equals_jax(tout, jout)
    assert tcp_tool.main(["--checkpoint", str(tmp_path / "none"), "--out",
                          str(tmp_path / "x")]) == 2
