"""The port's training loop end to end (``ncnet_tpu_torch/training/
train.py::fit``, ``data/datasets.py::ImagePairDataset``, ``cli/train.py``,
the training fault hooks, the step-window tracer) against the JAX package
on the CPU.

The fixture is the JAX package's JPEG pair dataset (``write_pair_dataset``,
64 × 64, each target its source shifted by one 16-px cell) converted to the
raw form by ``tools/convert_images.py`` (ROADMAP D1), so both packages read
PIL's pixels.  Both start from the same weights: the JAX init saved by the
JAX ``save_params`` and, through ``params_from_numpy``, by the port's.  The
JAX ``fit`` runs with ``data_parallel=False``, as the port runs on one
device.

Tolerances, each with its reason:
  * data: samples bit-equal (the same numpy arithmetic on the same pixels);
  * versions, positions, ``best`` flags, the NaN pattern, events: equal;
  * per-epoch losses: 1e-5 absolute.  fp32 losses of two libraries agree
    to ~1e-7 on the same params (tests/test_torch_port_train.py); after
    Adam steps the params differ: Adam's first update is ``−lr·g/(|g| +
    eps)``, ``±lr`` wherever ``|g| ≫ eps``, so a gradient that is zero up
    to rounding may take either sign, and such cells move by up to
    ``2·lr`` (lr = 1e-4 here); those are the cells the loss barely
    depends on, so the epoch losses move far less than the params;
  * one step with a recipe option: the loss to 1e-6 absolute in fp32
    (2⁻⁸ in bf16: two bf16 ulps of a ~0.3 score, the loss itself below
    −16·2⁻⁸); the NC gradients (Adam's ``mu``, ``(1 − b1)·g`` after one
    step) to normalized 1e-4 in fp32, and in bf16 to the relative L2 of
    ``BF16_GRAD_RTOL``; params to ``2·lr`` at the worst cell, and to 1e-6
    where the update's sign is decided: in fp32 where the JAX step moved
    the cell by more than ``lr/2`` (the same Adam sign note), in bf16
    where JAX's gradient is above 1e-2 of its tensor's max (the sign
    flips measured lie below 1.5e-3);
  * resumes (SIGTERM, kill mid-save): bit-equal to the uninterrupted run.
"""

import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ncnet_tpu import config as jcfg
from ncnet_tpu import training as jtrain
from ncnet_tpu.cli import train as jcli
from ncnet_tpu.data import ImagePairDataset as JImagePairDataset
from ncnet_tpu.data.synthetic import make_shifted_pair as jmake_shifted_pair
from ncnet_tpu.data.synthetic import write_pair_dataset as jwrite_pair_dataset
from ncnet_tpu.models import checkpoint as jckpt
from ncnet_tpu.models import ncnet as jnet
from ncnet_tpu.utils import faults as jfaults
from ncnet_tpu_torch import config as tcfg
from ncnet_tpu_torch import training as ttrain
from ncnet_tpu_torch.cli import train as tcli
from ncnet_tpu_torch.data import ImagePairDataset
from ncnet_tpu_torch.data.datasets import raw_path
from ncnet_tpu_torch.data.synthetic import write_pair_dataset
from ncnet_tpu_torch.models import checkpoint as tckpt
from ncnet_tpu_torch.models.convert import params_from_numpy
from ncnet_tpu_torch.observability import events as tevents
from ncnet_tpu_torch.observability.device import Heartbeat
from ncnet_tpu_torch.tools import convert_images
from ncnet_tpu_torch.training import train as ttrain_mod
from ncnet_tpu_torch.utils import faults as tfaults
from ncnet_tpu_torch.utils import profiling as tprof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(backbone="tiny", ncons_kernel_sizes=(3, 3), ncons_channels=(4, 1))
LR = 1e-4
SIDE = 64


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """The converted JPEG dataset and the start weights in both formats."""
    tmp = tmp_path_factory.mktemp("fit")
    root = str(tmp / "data")
    jwrite_pair_dataset(root, n_pairs=4, image_hw=(SIDE, SIDE), shift=(16, 16),
                        seed=3)
    # the same pairs, flipped, for the flip branch of the datasets
    with open(os.path.join(root, "image_pairs", "train_pairs.csv")) as f:
        lines = f.read().splitlines()
    with open(os.path.join(root, "image_pairs", "flip_pairs.csv"), "w") as f:
        f.write("\n".join([lines[0]] + [ln[:-1] + "1" for ln in lines[1:]])
                + "\n")
    assert not convert_images.convert_tree(root)["failed"]
    jp = jax.tree.map(np.asarray, jnet.init_ncnet(jcfg.ModelConfig(**TINY),
                                                  jax.random.key(0)))
    jp["nc"] = [{"w": layer["w"], "b": layer["b"] + 0.05} for layer in jp["nc"]]
    jstart, tstart = str(tmp / "start_jax"), str(tmp / "start_port")
    jckpt.save_params(jstart, jcfg.ModelConfig(**TINY), jp)
    tckpt.save_params(tstart, tcfg.ModelConfig(**TINY), params_from_numpy(jp))
    return {"root": root, "tmp": tmp, "jp": jp, "jstart": jstart,
            "tstart": tstart}


def train_kw(fixture, **kw):
    root = fixture["root"]
    base = dict(image_size=SIDE, dataset_image_path=root,
                dataset_csv_path=os.path.join(root, "image_pairs"),
                num_epochs=2, batch_size=2, lr=LR, log_interval=10,
                data_parallel=False, checkpoint_steps=1, keep_checkpoints=0)
    base.update(kw)
    return base


def port_config(fixture, out, checkpoint=None, **kw):
    return tcfg.TrainConfig(
        model=tcfg.ModelConfig(**TINY,
                               checkpoint=checkpoint or fixture["tstart"]),
        result_model_dir=str(out), **train_kw(fixture, **kw))


def jax_config(fixture, out, **kw):
    return jcfg.TrainConfig(
        model=jcfg.ModelConfig(**TINY, checkpoint=fixture["jstart"]),
        result_model_dir=str(out), **train_kw(fixture, **kw))


def assert_trees_equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_trees_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert_trees_equal(a, b)
    elif not torch.is_tensor(want):
        assert got == want
    else:
        assert got.dtype == want.dtype and torch.equal(got.cpu(), want.cpu())


def version_payload(version_dir):
    """A version's params and opt trees and its config.json."""
    with open(os.path.join(version_dir, "config.json")) as f:
        meta = json.load(f)
    return (tckpt.load_tree(version_dir, tckpt.PARAMS_FILE),
            tckpt.load_tree(version_dir, ttrain_mod.OPT_FILE), meta)


def assert_versions_bit_equal(a_dir, b_dir):
    pa, oa, _ = version_payload(a_dir)
    pb, ob, _ = version_payload(b_dir)
    assert_trees_equal(pa, pb)
    assert_trees_equal(oa, ob)


def version_names(root):
    return [os.path.basename(p) for _, p in tckpt.list_checkpoint_versions(root)]


# ---------------------------------------------------------------------------
# the data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("csv_file", ["train_pairs.csv", "flip_pairs.csv"])
@pytest.mark.parametrize("random_crop", [False, True])
def test_image_pair_dataset_matches_jax(fixture, csv_file, random_crop):
    root = fixture["root"]
    kw = dict(output_size=(48, 56), random_crop=random_crop, seed=7)
    jd = JImagePairDataset(os.path.join(root, "image_pairs"), csv_file, root, **kw)
    td = ImagePairDataset(os.path.join(root, "image_pairs"), csv_file, root, **kw)
    assert len(td) == len(jd) == 4
    for epoch in (1, 2):
        jd.set_epoch(epoch)
        td.set_epoch(epoch)
        for idx in range(len(td)):
            got, want = td[idx], jd[idx]
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
                assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype


def test_write_pair_dataset_writes_the_jax_pairs(tmp_path):
    """The port's writer draws the JAX writer's pixels (before its JPEG
    encoding) and writes the same CSVs, the images in their raw form."""
    troot, jroot = str(tmp_path / "t"), str(tmp_path / "j")
    write_pair_dataset(troot, n_pairs=3, image_hw=(40, 48), shift=(8, -16), seed=5)
    jwrite_pair_dataset(jroot, n_pairs=3, image_hw=(40, 48), shift=(8, -16), seed=5)
    for split in ("train", "val"):
        rel = os.path.join("image_pairs", f"{split}_pairs.csv")
        with open(os.path.join(troot, rel)) as f, open(os.path.join(jroot, rel)) as g:
            assert f.read() == g.read()
    rng = np.random.default_rng(5)
    for split in ("train", "val"):
        for i in range(3):
            src, tgt = jmake_shifted_pair(rng, 40, 48, (8, -16))
            for arr, tag in ((src, "a"), (tgt, "b")):
                got = np.load(raw_path(os.path.join(
                    troot, "images", f"{split}_{i}_{tag}.jpg")))
                np.testing.assert_array_equal(got, arr)


# ---------------------------------------------------------------------------
# fit against the JAX fit
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fits(fixture):
    """Both packages' 2-epoch fp32 runs with a NaN injected at step 2, and
    the port's with a profiled step window."""
    tmp = fixture["tmp"]
    with jfaults.injected(jfaults.FaultPlan(nan_loss_steps=(2,))):
        jres = jtrain.fit(jax_config(fixture, tmp / "jfit"), progress=False)
    os.environ[tprof.PROFILE_STEPS_ENV] = "2:4"
    try:
        with tfaults.injected(tfaults.FaultPlan(nan_loss_steps=(2,))):
            tres = ttrain.fit(port_config(fixture, tmp / "tfit",
                                          profile_dir=str(tmp / "tprof")),
                              progress=False, device="cpu")
    finally:
        del os.environ[tprof.PROFILE_STEPS_ENV]
    return jres, tres


def test_fit_matches_jax(fits):
    jres, tres = fits
    assert tres["nan_steps_skipped"] == jres["nan_steps_skipped"] == 1
    assert tres["preempted"] is jres["preempted"] is False
    assert tres["quarantined"] == jres["quarantined"] == []
    np.testing.assert_allclose(tres["train_loss"], jres["train_loss"], atol=1e-5)
    np.testing.assert_allclose(tres["test_loss"], jres["test_loss"], atol=1e-5)
    troot, jroot = tres["checkpoint"], jres["checkpoint"]
    assert version_names(troot) == version_names(jroot) == [
        "step_00000001", "step_00000002", "step_00000003", "step_00000004"]
    for name in version_names(troot):
        with open(os.path.join(troot, name, "config.json")) as f:
            tdoc = json.load(f)
        with open(os.path.join(jroot, name, "config.json")) as f:
            jdoc = json.load(f)
        assert list(tdoc) == list(jdoc)
        for key in ("_epoch", "_step", "_position"):
            assert tdoc[key] == jdoc[key], (name, key)
        assert [v is None for v in tdoc["_train_loss"]] \
            == [v is None for v in jdoc["_train_loss"]]
    # the best copy, beside each root
    for root in (troot, jroot):
        assert os.path.isdir(os.path.join(os.path.dirname(root),
                                          "best_" + os.path.basename(root)))
    # the guarded step 2 kept step 1's params and Adam state
    p1, o1, _ = version_payload(os.path.join(troot, "step_00000001"))
    p2, o2, _ = version_payload(os.path.join(troot, "step_00000002"))
    assert_trees_equal(p2, p1)
    assert_trees_equal(o2["opt_state"], o1["opt_state"])
    # the returned state is the last version, and it loads as a model
    _, params = tckpt.load_params(troot)
    assert_trees_equal(params, tckpt.cpu_tree(tres["state"].params))
    assert tckpt.verify_checkpoint_payload(troot, params)


def test_fit_telemetry_matches_jax(fits):
    """The same event types in the same numbers, the heartbeat at the last
    step, the profiled window's trace on disk."""
    jres, tres = fits
    counts, bests = {}, {}
    for tag, root in (("t", tres["checkpoint"]), ("j", jres["checkpoint"])):
        _, events = tevents.replay_events(
            os.path.join(root, "telemetry", "events.jsonl"))
        names = [e["event"] for e in events]
        bests[tag] = [(e["epoch"], e["best"]) for e in events
                      if e["event"] in ("epoch_end", "checkpoint_commit")]
        counts[tag] = {n: names.count(n) for n in (
            "run_start", "epoch_start", "step", "nan_skip", "checkpoint_commit",
            "epoch_end", "metrics", "run_end", "quality")}
        assert Heartbeat.read(os.path.join(root, "telemetry",
                                           "heartbeat.json"))["step"] == 4
    assert counts["t"] == counts["j"]
    assert bests["t"] == bests["j"]  # the best flags, commit by commit
    assert counts["t"]["step"] == 4 and counts["t"]["checkpoint_commit"] == 6
    trace = os.path.join(os.path.dirname(tres["checkpoint"]), "..", "tprof",
                         "trace_steps_2-4.json")
    with open(trace) as f:
        assert json.load(f)["traceEvents"]


def test_sigterm_resume_is_bit_equal(fixture, tmp_path):
    """Preempted by SIGTERM after step 3 (a boundary checkpoint), then
    resumed in place from the root: the final version equals an
    uninterrupted run's, bit for bit."""
    full = ttrain.fit(port_config(fixture, tmp_path / "full", telemetry=False),
                      progress=False, device="cpu")
    with tfaults.injected(tfaults.FaultPlan(sigterm_at_step=3)):
        cut = ttrain.fit(port_config(fixture, tmp_path / "cut", telemetry=False),
                         progress=False, device="cpu")
    assert cut["preempted"] and version_names(cut["checkpoint"])[-1] \
        == "step_00000003"
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
    resumed = ttrain.fit(port_config(fixture, tmp_path / "unused",
                                     checkpoint=cut["checkpoint"],
                                     telemetry=False),
                         progress=False, device="cpu")
    assert resumed["checkpoint"] == cut["checkpoint"] and not resumed["preempted"]
    assert resumed["state"].step == full["state"].step == 4
    assert_versions_bit_equal(
        os.path.join(cut["checkpoint"], "step_00000004"),
        os.path.join(full["checkpoint"], "step_00000004"))
    np.testing.assert_array_equal(resumed["test_loss"], full["test_loss"])


def cli_args(fixture, out, checkpoint):
    return ["--checkpoint", checkpoint, "--image_size", str(SIDE),
            "--dataset_image_path", fixture["root"],
            "--dataset_csv_path", os.path.join(fixture["root"], "image_pairs"),
            "--num_epochs", "2", "--batch_size", "2", "--lr", str(LR),
            "--checkpoint_steps", "1", "--keep_checkpoints", "2",
            "--result-model-dir", str(out), "--no_telemetry", "--device", "cpu"]


def run_cli(args, **env):
    return subprocess.run(
        [sys.executable, "-m", "ncnet_tpu_torch.cli.train"] + args, cwd=REPO,
        env={**os.environ, **env}, capture_output=True, text=True, timeout=300)


def test_kill_mid_save_resume_is_bit_equal(fixture, tmp_path):
    """The CLI in subprocesses: SIGKILLed between the params and opt writes
    of version 3 (a ``.tmp`` carcass, versions 1 and 2 intact), then
    resumed from the root: its last version equals an uninterrupted CLI
    run's, bit for bit."""
    full = run_cli(cli_args(fixture, tmp_path / "full", fixture["tstart"]))
    assert full.returncode == 0, full.stderr[-2000:]
    killed = run_cli(cli_args(fixture, tmp_path / "cut", fixture["tstart"]),
                     NCNET_TPU_FAULTS=json.dumps({"kill_at_version": 3}))
    assert killed.returncode == -signal.SIGKILL
    (root,) = [str(tmp_path / "cut" / n) for n in os.listdir(tmp_path / "cut")
               if not n.startswith("best_")]
    assert sorted(os.listdir(root)) == ["step_00000001", "step_00000002",
                                        "step_00000003.tmp"]
    resumed = run_cli(cli_args(fixture, tmp_path / "unused", root))
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    assert "Done!" in resumed.stdout
    assert version_names(root) == ["step_00000003", "step_00000004"]
    (full_root,) = [str(tmp_path / "full" / n)
                    for n in os.listdir(tmp_path / "full")
                    if not n.startswith("best_")]
    assert_versions_bit_equal(os.path.join(root, "step_00000004"),
                              os.path.join(full_root, "step_00000004"))


def test_divergence_raises_as_in_jax(fixture, tmp_path):
    plan = dict(nan_loss_steps=(1, 2))
    with jfaults.injected(jfaults.FaultPlan(**plan)):
        with pytest.raises(jtrain.TrainDivergedError):
            jtrain.fit(jax_config(fixture, tmp_path / "j", max_bad_steps=2,
                                  telemetry=False), progress=False)
    with tfaults.injected(tfaults.FaultPlan(**plan)):
        with pytest.raises(ttrain.TrainDivergedError, match="2 consecutive"):
            ttrain.fit(port_config(fixture, tmp_path / "t", max_bad_steps=2,
                                   telemetry=False), progress=False,
                       device="cpu")


def test_fit_and_the_cli_need_cuda_by_default(fixture, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.fit(port_config(fixture, tmp_path), progress=False)
    args = cli_args(fixture, tmp_path, fixture["tstart"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(args[:-2])


# ---------------------------------------------------------------------------
# the recipe options, one step against the JAX step
# ---------------------------------------------------------------------------


# bf16 gradients against the JAX package's XLA bf16 autodiff, relative L2
# per tensor: kernels 1.2e-2 measured at the worst, biases 1.7e-1 (a bias
# gradient sums the whole volume, and the two packages round that sum
# differently).  A sign-flipped, zeroed or random gradient is off by ≥ 1.
BF16_GRAD_RTOL = {"w": 3e-2, "b": 2.5e-1}


def assert_rel_l2(got, want, rtol):
    assert got.shape == want.shape
    err = np.linalg.norm(got - want) / max(1e-12, np.linalg.norm(want))
    assert err <= rtol, (err, rtol)


def peaked(jp, seed=0):
    rng = np.random.default_rng(seed)
    out = dict(jp)
    out["nc"] = []
    for layer in jp["nc"]:
        w = rng.normal(0, 0.05, layer["w"].shape).astype(np.float32)
        d = w.shape[0] // 2
        w[d, d, d, d] += 1.0 / w.shape[4]
        out["nc"].append({"w": w, "b": rng.normal(
            0.05, 0.02, layer["b"].shape).astype(np.float32)})
    return out


OPTIONS = {
    "fe_finetune_params": dict(fe_finetune_params=1),
    "finetune_cp_rank": dict(finetune_cp_rank=2),
    "remat_nc_layers": dict(remat_nc_layers=True),
    "nc_custom_grad": dict(nc_custom_grad=True),
    "nc_pallas_vjp": dict(nc_pallas_vjp=False),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_recipe_option_step_matches_jax(fixture, tmp_path, option):
    """One step of each once-refused option, built as ``fit`` builds it
    (``create_train_state`` on the same checkpoint, the chunk count, the
    frozen-trunk flag): loss and params against the JAX step.
    ``nc_pallas_vjp=False`` runs bf16 (the option matters only there),
    the others fp32."""
    half = option == "nc_pallas_vjp"
    kw = OPTIONS[option]
    jp = peaked(fixture["jp"]) if half else fixture["jp"]
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jckpt.save_params(jdir, jcfg.ModelConfig(**TINY), jp)
    tckpt.save_params(tdir, tcfg.ModelConfig(**TINY), params_from_numpy(jp))
    common = dict(batch_size=2, lr=LR, data_parallel=False, **kw)
    jc = jcfg.TrainConfig(model=jcfg.ModelConfig(
        **TINY, checkpoint=jdir, half_precision=half), **common)
    tc = tcfg.TrainConfig(model=tcfg.ModelConfig(
        **TINY, checkpoint=tdir, half_precision=half), **common)
    jstate, jopt, jmc, _ = jtrain.create_train_state(jc)
    tstate, topt, tmc, _ = ttrain.create_train_state(tc, device="cpu")
    assert tmc.nc_tier == jmc.nc_tier
    step_kw = dict(
        stop_backbone_grad=tc.fe_finetune_params == 0,
        remat_nc_layers=tc.remat_nc_layers, nc_custom_grad=tc.nc_custom_grad,
        accum_chunks=ttrain_mod._resolve_accum_chunks(tc), nan_guard=True,
        nc_pallas_vjp=tc.nc_pallas_vjp)
    assert step_kw["accum_chunks"] == jtrain.train._resolve_accum_chunks(jc, 1)
    src = np.random.default_rng(4).uniform(-1, 1, (2, SIDE, SIDE, 3)
                                           ).astype(np.float32)
    nb = {"source_image": src,
          "target_image": np.roll(src, (16, 16), axis=(1, 2)).copy()}
    jnew, jloss = jtrain.make_train_step(jmc, jopt, donate=False, **step_kw)(
        jstate, {k: jnp.asarray(v) for k, v in nb.items()})
    tnew, tloss = ttrain.make_train_step(tmc, topt, **step_kw)(tstate, nb)
    if half:  # the shifted pairs score well above the rolled ones
        assert float(jloss) < -16 * 2.0 ** -8
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=0,
                               atol=2.0 ** -8 if half else 1e-6)
    # the gradients: after one step Adam's mu is (1 − b1)·g on both sides
    jmu = jnew.opt_state.inner_states["trainable"].inner_state[0].mu
    tgrads = list(tckpt._jax_leaves({"nc": tnew.opt_state.mu["nc"]}))
    jgrads = [np.asarray(g, np.float32) for g in jax.tree.leaves(jmu["nc"])]
    assert len(tgrads) == len(jgrads) > 0
    for (got, _, key), exp in zip(tgrads, jgrads):
        got = got.float().numpy()
        if half:
            assert_rel_l2(got, exp, BF16_GRAD_RTOL[key])
        else:
            scale = max(1e-12, float(np.abs(exp).max()))
            np.testing.assert_allclose(got / scale, exp / scale, atol=1e-4)
    grads = iter(jgrads)
    want = params_from_numpy(jax.tree.map(np.asarray, jnew.params))
    before = params_from_numpy(jax.tree.map(np.asarray, jstate.params))
    moved = 0
    for got, exp, old in zip(tckpt._jax_leaves(tnew.params),
                             tckpt._jax_leaves(want),
                             tckpt._jax_leaves(before)):
        in_trunk = got[1]
        got, exp, old = (t[0].float().numpy() for t in (got, exp, old))
        np.testing.assert_allclose(got, exp, atol=2 * LR + 1e-6)
        if not half:
            big = np.abs(exp - old) > 0.5 * LR
        elif in_trunk:  # frozen
            big = np.ones(got.shape, bool)
        else:  # the update's sign wherever |g| is well above bf16 noise
            g = np.abs(next(grads))
            big = g > 1e-2 * g.max()
        np.testing.assert_allclose(got[big], exp[big], atol=1e-6)
        moved += int(np.any(got != old))
    assert moved  # the step trained something
    if option == "fe_finetune_params":  # the (tiny) trunk trained too
        assert not torch.equal(tnew.params["backbone"]["conv1"]["w"],
                               tstate.params["backbone"]["conv1"]["w"])
    if option == "finetune_cp_rank":  # factors train, dense kernels ride along
        assert not torch.equal(tnew.params["nc"][0]["cp"]["cin"],
                               tstate.params["nc"][0]["cp"]["cin"])
        assert torch.equal(tnew.params["nc"][0]["w"], tstate.params["nc"][0]["w"])


def test_explicit_chunks_with_finetuning_raise(fixture, tmp_path):
    with pytest.raises(ValueError, match="frozen"):
        ttrain.fit(port_config(fixture, tmp_path, fe_finetune_params=1,
                               accum_chunks=2), progress=False, device="cpu")


# ---------------------------------------------------------------------------
# the CLI and the profiling knob
# ---------------------------------------------------------------------------


def test_cli_flags_are_the_jax_clis():
    jp, tp = jcli.build_parser(), tcli.build_parser()

    def flags(p):
        return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs,
                         type(a).__name__) for a in p._actions}

    jflags, tflags = flags(jp), flags(tp)
    assert tflags.pop("device")[1] == "cuda"
    assert tflags == jflags


@pytest.mark.parametrize("raw,want", [("", None), ("2:4", (2, 4)),
                                      (" 1:2 ", (1, 2)), ("3", ValueError),
                                      ("a:b", ValueError), ("0:2", ValueError),
                                      ("4:4", ValueError)])
def test_profile_step_window_parses_as_jax(monkeypatch, raw, want):
    from ncnet_tpu.utils import profiling as jprof

    monkeypatch.setenv(tprof.PROFILE_STEPS_ENV, raw)
    if want is ValueError:
        for mod in (tprof, jprof):
            with pytest.raises(ValueError, match=tprof.PROFILE_STEPS_ENV):
                mod.profile_step_window()
    else:
        assert tprof.profile_step_window() == jprof.profile_step_window() == want


def test_heartbeat_roundtrip(tmp_path):
    path = str(tmp_path / "t" / "heartbeat.json")
    assert Heartbeat.read(path) is None and Heartbeat.age_s(path) is None
    Heartbeat(path, run_id="r1").beat(step=7, phase="train")
    doc = Heartbeat.read(path)
    assert doc["step"] == 7 and doc["run"] == "r1" and doc["phase"] == "train"
    assert doc["pid"] == os.getpid() and 0 <= Heartbeat.age_s(path) < 60
