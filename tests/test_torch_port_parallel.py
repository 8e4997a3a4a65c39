"""The port's multi-device layer (``ncnet_tpu_torch/parallel/``) and
data-parallel ``fit`` against the JAX package on the CPU.

  * The hB-sharded filter and forward run on meshes that name the CPU
    several times (``make_mesh(devices=["cpu"] * n)``, ROADMAP D7: the
    shards share one device, every halo and max exchange still runs),
    against the JAX package's *unsharded* ``ncnet_filter`` /
    ``ncnet_forward`` / ``correlation_4d``, one case for each case of
    ``tests/test_spatial.py``.
  * ``fit`` at world 2 runs in two fresh interpreters
    (``tests/torch_port_dp_worker.py``: torch and the port only), joined
    by gloo through a ``FileStore`` rendezvous in the test's directory,
    each with its own timeout, against the JAX single-device ``fit`` and
    the port's world-1 ``fit`` on the same data and start weights.  The
    global batch is 4 with one step an epoch, so both runs see the same
    pairs in each step, and the global roll's negatives differ from a
    per-rank roll's (pair 1's negative is pair 2, on the other rank).

Tolerances, each with its reason:
  * filter, forward, correlation in fp32: rtol and atol 2e-5
    (``tests/test_spatial.py``'s bound: the valid-dim convolutions sum in
    their own order); the bf16 forward: 2e-2 (its bf16 bound); the
    relocalization offsets exactly;
  * ``fit``: per-epoch losses (one step each) within 1e-5 absolute; final
    params within 1e-5 wherever the reference run moved the cell by more
    than lr/2 (Adam's step is ±lr wherever |g| ≫ eps, so a cell whose
    gradient is zero up to rounding may step either way: there the
    params agree to 2·lr, ``tests/test_torch_port_fit.py``'s note);
  * a SIGTERM to one rank: both ranks stop at the same step, and the
    resumed run ends bit-equal to the uninterrupted one;
  * the telemetry's ``grad_norm`` at world 2: the world-1 run's within
    rtol 1e-5 (the ranks' parts summed in another order).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ncnet_tpu import config as jcfg
from ncnet_tpu import training as jtrain
from ncnet_tpu.data.synthetic import write_pair_dataset as jwrite_pair_dataset
from ncnet_tpu.models import checkpoint as jckpt
from ncnet_tpu.models import ncnet as jnet
from ncnet_tpu.ops import correlation_4d as jcorrelation_4d
from ncnet_tpu_torch import config as tcfg
from ncnet_tpu_torch import parallel
from ncnet_tpu_torch import training as ttrain
from ncnet_tpu_torch.models import checkpoint as tckpt
from ncnet_tpu_torch.models import ncnet as tnet
from ncnet_tpu_torch.models.convert import params_from_numpy
from ncnet_tpu_torch.parallel import spatial as tspatial
from ncnet_tpu_torch.tools import convert_images

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_dp_worker.py")


def cpu_mesh(data, spatial):
    return parallel.make_mesh(data=data, spatial=spatial,
                              devices=["cpu"] * (data * spatial))


def volume_cfgs(**kw):
    base = dict(backbone="tiny", ncons_kernel_sizes=(5, 3), ncons_channels=(6, 1))
    base.update(kw)
    return jcfg.ModelConfig(**base), tcfg.ModelConfig(**base)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def test_make_mesh_grid_and_refusals(monkeypatch):
    mesh = cpu_mesh(2, 3)
    assert mesh.shape == {parallel.DATA_AXIS: 2, parallel.SPATIAL_AXIS: 3}
    assert all(d == torch.device("cpu") for d in mesh.devices.ravel())
    assert parallel.make_mesh(spatial=2, devices=["cpu"] * 4).shape == {
        "data": 2, "spatial": 2}
    with pytest.raises(ValueError, match="need 4 devices, have 3"):
        parallel.make_mesh(data=2, spatial=2, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="not divisible"):
        parallel.make_mesh(spatial=2, devices=["cpu"] * 3)
    # by default the CUDA devices, each once: a one-GPU machine has too few
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        parallel.make_mesh(data=1, spatial=2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert [str(d) for d in parallel.make_mesh(data=1, spatial=2).row(0)] == [
        "cuda:0", "cuda:1"]


@pytest.mark.parametrize("hb,k,n,ks", [(200, 2, 8, (5, 5, 5)), (20, 2, 8, (3, 3)),
                                       (7, 2, 4, (3,)), (8, 1, 8, (5, 3)),
                                       (12, 2, 2, (3, 3)), (16, 1, 4, (5,))])
def test_shard_plan_matches_jax(hb, k, n, ks):
    from ncnet_tpu.parallel import spatial as jspatial

    assert tspatial.padded_hb(hb, k, n) == jspatial.padded_hb(hb, k, n)
    assert tspatial.shardable_hb(hb, k, n, ks) == jspatial.shardable_hb(hb, k, n, ks)


# ---------------------------------------------------------------------------
# the sharded filter and forward (the cases of tests/test_spatial.py)
# ---------------------------------------------------------------------------

SPATIAL_CASES = {
    # rectangular InLoc-like volume, no relocalization (shards of 2 and 4)
    "rectangular_1x8": dict(kind="filter", mesh=(1, 8), shape=(1, 5, 7, 16, 6), key=0),
    "rectangular_2x4": dict(kind="filter", mesh=(2, 4), shape=(2, 5, 7, 16, 6), key=0),
    # k=2: the pooled volume and the four offset grids
    "relocalization": dict(kind="filter", mesh=(1, 4), shape=(1, 6, 8, 16, 12),
                           key=1, cfg=dict(relocalization_k_size=2)),
    # the hB-only halo path
    "asymmetric": dict(kind="filter", mesh=(1, 8), shape=(1, 4, 5, 16, 7), key=2,
                       cfg=dict(symmetric_mode=False)),
    "correlation": dict(kind="correlation", mesh=(2, 4)),
    # images → features → sharded correlation → sharded filter, bf16
    "forward_bf16": dict(kind="forward", mesh=(1, 4), key=3, tgt_h=256,
                         cfg=dict(half_precision=True, relocalization_k_size=2)),
    # pad-and-mask: hB not dividing the shards
    "padded_4x10": dict(kind="filter", mesh=(1, 4), shape=(1, 5, 7, 10, 6), key=4),
    "padded_8x20": dict(kind="filter", mesh=(1, 8), shape=(1, 5, 7, 20, 6), key=4),
    "padded_relocalization": dict(kind="filter", mesh=(1, 8), shape=(1, 6, 8, 20, 12),
                                  key=5, cfg=dict(relocalization_k_size=2)),
    "padded_three_layer": dict(kind="filter", mesh=(1, 4), shape=(1, 5, 7, 10, 6),
                               key=6, cfg=dict(ncons_kernel_sizes=(3, 3, 3),
                                               ncons_channels=(4, 4, 1))),
    "forward_padded": dict(kind="forward", mesh=(1, 4), key=8, tgt_h=320,
                           cfg=dict(relocalization_k_size=2)),
    # 3 layers are not tap-swap-fusable: the transposed pass's halos
    "three_layer_transpose": dict(kind="filter", mesh=(1, 4), shape=(1, 5, 7, 16, 6),
                                  key=7, cfg=dict(ncons_kernel_sizes=(3, 3, 3),
                                                  ncons_channels=(4, 4, 1))),
    "unshardable": dict(kind="refusal"),
}


def assert_outputs_close(got, want, tol):
    gc = got.corr.float().numpy()
    wc = np.asarray(want.corr, dtype=np.float32)
    assert gc.shape == wc.shape
    np.testing.assert_allclose(gc, wc, rtol=tol, atol=tol)
    assert (got.delta4d is None) == (want.delta4d is None)
    if want.delta4d is not None:
        for g, w in zip(got.delta4d, want.delta4d):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", sorted(SPATIAL_CASES))
def test_spatial_matches_jax_unsharded(case):
    spec = SPATIAL_CASES[case]
    rng = np.random.default_rng(0)
    if spec["kind"] == "correlation":
        fa = rng.standard_normal((2, 5, 7, 16)).astype(np.float32)
        fb = rng.standard_normal((2, 8, 6, 16)).astype(np.float32)
        want = np.asarray(jcorrelation_4d(jnp.asarray(fa), jnp.asarray(fb)))
        mesh = cpu_mesh(*spec["mesh"])
        got = []
        for d in range(2):
            shards = parallel.spatial_correlation(
                torch.from_numpy(fa[d:d + 1]), torch.from_numpy(fb[d:d + 1]),
                mesh.row(d))
            assert len(shards) == 4 and all(s.shape[3] == 2 for s in shards)
            got.append(torch.cat(shards, dim=3))
        np.testing.assert_allclose(torch.cat(got).numpy(), want, rtol=1e-5,
                                   atol=1e-5)
        return
    if spec["kind"] == "refusal":
        # k=2 with an odd fine hB (ragged pooling), and a kernel-5 halo of 2
        # taller than the post-pad shards of 1
        jc, tc = volume_cfgs(relocalization_k_size=2)
        tp = params_from_numpy(jax.tree.map(np.asarray, jnet.init_ncnet(
            jc, jax.random.key(0))))
        corr = torch.from_numpy(rng.standard_normal((1, 4, 4, 7, 4)).astype(np.float32))
        with pytest.raises(ValueError, match="spatial shards"):
            parallel.spatial_filter(tc, tp, corr, cpu_mesh(1, 4))
        _, tc = volume_cfgs()
        corr = torch.from_numpy(rng.standard_normal((1, 4, 4, 8, 4)).astype(np.float32))
        with pytest.raises(ValueError, match="spatial shards"):
            parallel.spatial_filter(tc, tp, corr, cpu_mesh(1, 8))
        return
    jc, tc = volume_cfgs(**spec.get("cfg", {}))
    jp = jnet.init_ncnet(jc, jax.random.key(spec["key"]))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    mesh = cpu_mesh(*spec["mesh"])
    if spec["kind"] == "filter":
        corr = rng.standard_normal(spec["shape"]).astype(np.float32)
        want = jnet.ncnet_filter(jc, jp, jnp.asarray(corr))
        with torch.no_grad():
            got = parallel.spatial_filter(tc, tp, torch.from_numpy(corr), mesh)
        assert_outputs_close(got, want, 2e-5)
        return
    src = rng.uniform(-1, 1, (1, 96, 128, 3)).astype(np.float32)
    tgt = rng.uniform(-1, 1, (1, spec["tgt_h"], 128, 3)).astype(np.float32)
    want = jnet.ncnet_forward(jc, jp, jnp.asarray(src), jnp.asarray(tgt))
    with torch.no_grad():
        got = parallel.spatial_forward(tc, tp, torch.from_numpy(src),
                                       torch.from_numpy(tgt), mesh)
    assert_outputs_close(got, want, 2e-2 if tc.half_precision else 2e-5)


def test_sharded_stack_runs_the_valid_conv4d_forms(monkeypatch):
    """The sharded NC stack convolves valid along the sharded dim through
    ``ops/conv4d.py`` (``pad_hb=False``, and ``pad_ha=False`` in the
    transposed pass), never the same-padded B5 form or the stack kernel."""
    from ncnet_tpu_torch.ops import conv4d_pallas, nc_fused_lane

    seen = []
    real = tspatial.conv4d

    def spy(x, w, b=None, **kw):
        seen.append((kw.get("pad_ha", True), kw.get("pad_hb", True)))
        return real(x, w, b, **kw)

    def forbidden(*a, **k):
        raise AssertionError("a kernel ran on the sharded path")

    monkeypatch.setattr(tspatial, "conv4d", spy)
    monkeypatch.setattr(conv4d_pallas, "conv4d_small_cout", forbidden)
    monkeypatch.setattr(nc_fused_lane, "nc_stack_resident", forbidden)
    rng = np.random.default_rng(1)
    for kw, want in ((dict(), {(True, False)}),
                     (dict(ncons_kernel_sizes=(3, 3, 3), ncons_channels=(4, 4, 1)),
                      {(True, False), (False, True)})):
        seen.clear()
        _, tc = volume_cfgs(**kw)
        tp = tnet.init_ncnet(tc, seed=0)
        corr = torch.from_numpy(rng.standard_normal((1, 5, 7, 16, 6)).astype(np.float32))
        with torch.no_grad():
            parallel.spatial_filter(tc, tp, corr, cpu_mesh(1, 2))
        assert set(seen) == want


# ---------------------------------------------------------------------------
# data-parallel fit
# ---------------------------------------------------------------------------

TINY = dict(backbone="tiny", ncons_kernel_sizes=(3, 3), ncons_channels=(4, 1))
LR = 1e-4
SIDE = 64


@pytest.fixture(scope="module")
def dp_fixture(tmp_path_factory):
    """The JAX package's pair dataset (4 train and 4 val pairs, 64 × 64,
    each target its source moved by one 16-px cell) in the raw form both
    packages read, and the start weights in both formats."""
    tmp = tmp_path_factory.mktemp("dp")
    root = str(tmp / "data")
    jwrite_pair_dataset(root, n_pairs=4, image_hw=(SIDE, SIDE), shift=(16, 16),
                        seed=3)
    assert not convert_images.convert_tree(root)["failed"]
    jp = jax.tree.map(np.asarray, jnet.init_ncnet(jcfg.ModelConfig(**TINY),
                                                  jax.random.key(0)))
    jp["nc"] = [{"w": layer["w"], "b": layer["b"] + 0.05} for layer in jp["nc"]]
    jstart, tstart = str(tmp / "start_jax"), str(tmp / "start_port")
    jckpt.save_params(jstart, jcfg.ModelConfig(**TINY), jp)
    tckpt.save_params(tstart, tcfg.ModelConfig(**TINY), params_from_numpy(jp))
    return {"root": root, "jstart": jstart, "tstart": tstart}


def train_fields(fx, out, **kw):
    root = fx["root"]
    base = dict(image_size=SIDE, dataset_image_path=root,
                dataset_csv_path=os.path.join(root, "image_pairs"),
                num_epochs=2, batch_size=4, lr=LR, log_interval=10,
                checkpoint_steps=1, keep_checkpoints=0, telemetry=False,
                result_model_dir=str(out))
    base.update(kw)
    return base


def launch_world(fx, out, world=2, sigterm_at_step=(-1, -1), checkpoint=None,
                 timeout_s=240, model=TINY, fail_save_rank=-1, **kw):
    """``fit`` at ``world`` ranks, each a fresh interpreter; returns each
    rank's exit code and output."""
    os.makedirs(out, exist_ok=True)
    model = dict(model, checkpoint=checkpoint or fx["tstart"])
    job = {"world": world, "rendezvous": os.path.join(out, "rendezvous"),
           "timeout_s": timeout_s, "out": out,
           "sigterm_at_step": list(sigterm_at_step),
           "fail_save_rank": fail_save_rank,
           "train": dict(train_fields(fx, os.path.join(out, "ckpt"), **kw),
                         model=model, distributed=True)}
    job_path = os.path.join(out, "job.json")
    with open(job_path, "w") as f:
        json.dump(job, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen([sys.executable, WORKER, job_path, str(r)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout_s)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, log) for p, log in zip(procs, logs)]


def run_world(fx, out, world=2, **kw):
    """:func:`launch_world`, every rank exiting 0; returns the ranks'
    result documents and final params."""
    for r, (code, log) in enumerate(launch_world(fx, out, world=world, **kw)):
        assert code == 0, f"rank {r} exited {code}:\n{log[-4000:]}"
    docs, params = [], []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            docs.append(json.load(f))
        params.append(torch.load(os.path.join(out, f"rank{r}.pt"),
                                 weights_only=True))
    return docs, params


def assert_params_close(got, want, start):
    """:data:`LR`-scaled Adam tolerance (the module docstring)."""
    n = 0
    for (g, _, _), (w, _, _), (s, _, _) in zip(
            tckpt._jax_leaves(got), tckpt._jax_leaves(want),
            tckpt._jax_leaves(start)):
        g, w, s = (t.float().numpy() for t in (g, w, s))
        np.testing.assert_allclose(g, w, atol=2 * LR + 1e-6)
        big = np.abs(w - s) > 0.5 * LR
        np.testing.assert_allclose(g[big], w[big], atol=1e-5)
        n += int(big.sum())
    assert n  # the run trained something


@pytest.fixture(scope="module")
def dp_runs(dp_fixture, tmp_path_factory):
    """JAX single-device fit, the port's world-1 fit and its world-2 fit,
    all with the frozen trunk."""
    tmp = tmp_path_factory.mktemp("dp_runs")
    jres = jtrain.fit(jcfg.TrainConfig(
        model=jcfg.ModelConfig(**TINY, checkpoint=dp_fixture["jstart"]),
        **train_fields(dp_fixture, tmp / "jax", data_parallel=False)),
        progress=False)
    one = ttrain.fit(tcfg.TrainConfig(
        model=tcfg.ModelConfig(**TINY, checkpoint=dp_fixture["tstart"]),
        **train_fields(dp_fixture, tmp / "one")), progress=False, device="cpu")
    docs, params = run_world(dp_fixture, str(tmp / "two"))
    return jres, one, docs, params


def test_fit_world2_matches_jax_and_world1(dp_fixture, dp_runs):
    jres, one, docs, params = dp_runs
    _, start = tckpt.load_params(dp_fixture["tstart"])
    want = params_from_numpy(jax.tree.map(np.asarray, jres["state"].params))
    assert [d["world"] for d in docs] == [2, 2]
    for doc in docs:  # every rank: the global batch's losses
        assert doc["step"] == 2 and not doc["preempted"]
        np.testing.assert_allclose(doc["train_loss"], jres["train_loss"], atol=1e-5)
        np.testing.assert_allclose(doc["test_loss"], jres["test_loss"], atol=1e-5)
        np.testing.assert_allclose(doc["train_loss"], one["train_loss"], atol=1e-5)
    # one model on both ranks, bit for bit
    for (a, _, _), (b, _, _) in zip(tckpt._jax_leaves(params[0]),
                                    tckpt._jax_leaves(params[1])):
        assert torch.equal(a, b)
    assert_params_close(params[0], want, start)
    assert_params_close(params[0], tckpt.cpu_tree(one["state"].params), start)
    # rank 0 alone wrote the root, with the versions of a one-process run
    root = docs[0]["checkpoint"]
    assert docs[1]["checkpoint"] == root
    names = [os.path.basename(p) for _, p in tckpt.list_checkpoint_versions(root)]
    assert names == ["step_00000001", "step_00000002"]
    _, saved = tckpt.load_params(root)
    for (a, _, _), (b, _, _) in zip(tckpt._jax_leaves(saved),
                                    tckpt._jax_leaves(params[0])):
        assert torch.equal(a, b)


def test_global_roll_is_not_the_per_rank_roll(dp_fixture, dp_runs):
    """The batch makes the two rolls differ: a per-rank roll (each rank's
    two pairs negatives of each other) gives a loss 2.5e-4 away from the
    global roll's (measured), ten times the 1e-5 the runs above agree to,
    so a port that rolled per rank would fail them."""
    jres, _, _, _ = dp_runs
    from ncnet_tpu_torch.data import ImagePairDataset
    from ncnet_tpu_torch.training import loss as tloss

    root = dp_fixture["root"]
    ds = ImagePairDataset(os.path.join(root, "image_pairs"), "val_pairs.csv",
                          root, output_size=(SIDE, SIDE), seed=1)
    ds.set_epoch(1)
    items = [ds[i] for i in range(4)]
    batch = {k: torch.from_numpy(np.stack([it[k] for it in items]))
             for k in ("source_image", "target_image")}
    mc, params = tckpt.load_params(dp_fixture["tstart"])
    with torch.no_grad():
        whole = float(tloss.weak_loss(mc, params, batch))
        per_rank = sum(float(tloss.weak_loss(
            mc, params, {k: v[h:h + 2] for k, v in batch.items()})) / 2
            for h in (0, 2))
    assert abs(whole - per_rank) > 1e-4, (whole, per_rank)


def test_finetuned_trunk_fit_world2_matches_jax(dp_fixture, tmp_path):
    """``fe_finetune_params=1`` (the tiny trunk trains whole): the gradient
    of the map a rank received from its neighbour goes back to its owner,
    so the trunk's update equals the single-device one."""
    jres = jtrain.fit(jcfg.TrainConfig(
        model=jcfg.ModelConfig(**TINY, checkpoint=dp_fixture["jstart"]),
        **train_fields(dp_fixture, tmp_path / "jax", data_parallel=False,
                       fe_finetune_params=1, num_epochs=1)), progress=False)
    docs, params = run_world(dp_fixture, str(tmp_path / "two"),
                             fe_finetune_params=1, num_epochs=1)
    _, start = tckpt.load_params(dp_fixture["tstart"])
    want = params_from_numpy(jax.tree.map(np.asarray, jres["state"].params))
    for doc in docs:
        np.testing.assert_allclose(doc["train_loss"], jres["train_loss"], atol=1e-5)
    assert not torch.equal(params[0]["backbone"]["conv1"]["w"],
                           start["backbone"]["conv1"]["w"])
    assert_params_close(params[0], want, start)


def step_grad_norms(events_path):
    with open(events_path) as f:
        lines = [json.loads(line) for line in f][1:]  # the header first
    return [e["grad_norm"] for e in lines if e["event"] == "step"]


def test_grad_norm_world2_equals_world1_with_frozen_trunk_leaves(dp_fixture,
                                                                 tmp_path):
    """The telemetry's ``grad_norm`` of a fine-tuned VGG-16 cut at pool3
    (``fe_finetune_params=1``: conv3_3 trains; the six convs before it are
    frozen yet differentiated, and the norm reads them as JAX's
    ``optax.global_norm`` does): rank 0's value at world 2 is the world-1
    run's within rtol 1e-5 (the two sum the ranks' parts in another
    order)."""
    vgg = dict(TINY, backbone="vgg", backbone_last_layer="pool3")
    mc = tcfg.ModelConfig(**vgg)
    start = str(tmp_path / "start")
    tckpt.save_params(start, mc, tnet.init_ncnet(mc, seed=0))
    labels = ttrain.trainable_labels(mc, tckpt.load_params(start)[1], 1)
    assert [c["w"] for c in labels["backbone"]["convs"]] == ["frozen"] * 6 + [
        "trainable"]
    kw = dict(fe_finetune_params=1, num_epochs=1, telemetry=True)
    one = str(tmp_path / "one")
    ttrain.fit(tcfg.TrainConfig(
        model=tcfg.ModelConfig(**vgg, checkpoint=start),
        **train_fields(dp_fixture, one, telemetry_dir=os.path.join(one, "tel"),
                       **kw)), progress=False, device="cpu")
    two = str(tmp_path / "two")
    run_world(dp_fixture, two, model=vgg, checkpoint=start,
              telemetry_dir=os.path.join(two, "tel"), **kw)
    want = step_grad_norms(os.path.join(one, "tel", "events.jsonl"))
    got = step_grad_norms(os.path.join(two, "tel", "events.jsonl"))
    assert len(want) == 1 and want[0] > 0
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_failed_save_on_rank0_raises_on_every_rank(dp_fixture, tmp_path):
    """Rank 0's checkpoint write fails (ENOSPC, one attempt at world 2):
    rank 0 raises it, and rank 1 raises the broadcast failure instead of
    waiting out the collective timeout."""
    results = launch_world(dp_fixture, str(tmp_path / "run"), fail_save_rank=0,
                           num_epochs=1)
    assert [code != 0 for code, _ in results] == [True, True]
    assert "No space left on device" in results[0][1]
    assert "rank 0 failed to save checkpoint" in results[1][1], results[1][1][-4000:]
    assert "No space left on device" in results[1][1]


def test_sigterm_to_one_rank_stops_both_and_resumes_bit_equal(dp_fixture, tmp_path):
    """Global batch 2 (one pair a rank), two steps an epoch: rank 1 alone
    gets SIGTERM after step 3; the ranks agree to stop there, rank 0
    commits step 3, and the run resumed from the root ends bit-equal to an
    uninterrupted world-2 run."""
    kw = dict(batch_size=2)
    full, full_params = run_world(dp_fixture, str(tmp_path / "full"), **kw)
    cut, _ = run_world(dp_fixture, str(tmp_path / "cut"),
                       sigterm_at_step=(-1, 3), **kw)
    assert [d["preempted"] for d in cut] == [True, True]
    assert [d["step"] for d in cut] == [3, 3]
    root = cut[0]["checkpoint"]
    assert [os.path.basename(p) for _, p in tckpt.list_checkpoint_versions(root)
            ][-1] == "step_00000003"
    resumed, resumed_params = run_world(dp_fixture, str(tmp_path / "resumed"),
                                        checkpoint=root, **kw)
    assert [d["step"] for d in resumed] == [4, 4] and resumed[0]["checkpoint"] == root
    for (a, _, _), (b, _, _) in zip(tckpt._jax_leaves(resumed_params[0]),
                                    tckpt._jax_leaves(full_params[0])):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(resumed[0]["test_loss"], full[0]["test_loss"])
