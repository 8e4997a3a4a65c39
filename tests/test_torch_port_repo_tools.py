"""The port's repository tools against the JAX package's root tools:
``check_no_bare_print``, ``make_goldens``, ``parity_kit`` and its
reference twin (``ncnet_tpu_torch/tools/``).

  * ``check_no_bare_print``: both checkers find the same planted
    ``print`` calls (the port also exempts ``tools/``), and the port's
    passes on its package;
  * ``make_goldens``: the port's ``deterministic_params`` equal, leaf for
    leaf and bit for bit, the JAX tool's after ``params_from_numpy``; the
    port's record has the JAX goldens' keys, and ``--check`` passes on the
    CPU at the JAX golden test's tolerances (rtol 1e-5 / atol 1e-6 for the
    forward, 1e-4 / 1e-5 for the trunk and dense SIFT, 1e-6 / 1e-8 for
    P3P), and fails on a perturbed golden;
  * ``parity_kit``: on the ``.pth.tar`` written by
    ``tests/test_parity_kit.py``'s recipe, the PCK command's result equal
    to the JAX kit's, ``--all`` passing its twin check, a trace the JAX kit
    wrote compared against one the port wrote (``--compare``, 1e-4: f32
    on both sides) in both directions, and the truncated-trace and
    perturbed-stage failures;
  * the reference twin equal, bit for bit, to the twins in
    ``tests/test_torch_parity.py`` and ``tests/test_inloc_match_parity.py``
    on the same inputs;
  * each tool refuses to run without a GPU unless the CPU is named.
"""

import argparse
import os
import warnings

import numpy as np
import pytest
import torch

from torch_port_tool_twins import jax_tool, port_tool

FWD_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    monkeypatch.setenv("NCNET_TPU_PERF_STORE", "off")


# ---------------------------------------------------------------------------
# check_no_bare_print
# ---------------------------------------------------------------------------


def test_bare_print_checker_finds_planted_calls(tmp_path, capsys):
    pkg = tmp_path / "pkg"
    for sub in ("", "ops", "cli", "tools"):
        (pkg / sub).mkdir(parents=True, exist_ok=True)
    (pkg / "ops" / "bad.py").write_text(
        'def f():\n    """print() in prose"""\n    print("x")  # print()\n')
    (pkg / "ok.py").write_text("import sys\nsys.stdout.write('x')\n")
    (pkg / "cli" / "main.py").write_text("print('banner')\n")
    (pkg / "tools" / "probe.py").write_text("print('result')\n")
    port, jax = port_tool("check_no_bare_print"), jax_tool("check_no_bare_print")
    bad = (str(pkg / "ops" / "bad.py"), 3)
    assert port.find_bare_prints(str(pkg)) == [bad]
    # the JAX checker exempts cli/ only
    assert sorted(jax.find_bare_prints(str(pkg))) == sorted(
        [bad, (str(pkg / "tools" / "probe.py"), 1)])
    assert port.main([str(pkg)]) == 1
    out = capsys.readouterr().out
    assert f"{bad[0]}:3" in out
    assert "ncnet_tpu_torch.observability.get_logger" in out
    assert port.main([str(pkg / "ok.py")]) == 0


def test_bare_print_checker_passes_on_the_package(capsys):
    assert port_tool("check_no_bare_print").main([]) == 0
    assert capsys.readouterr().out == ""


# ---------------------------------------------------------------------------
# make_goldens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backbone,kernels,channels,reloc", [
    ("tiny", (3, 3), (8, 1), 2),
    ("resnet101", (3,), (1,), 0),
])
def test_deterministic_params_match_the_jax_tool(backbone, kernels, channels,
                                                 reloc):
    import jax

    from ncnet_tpu.config import ModelConfig as JConfig
    from ncnet_tpu_torch.config import ModelConfig
    from ncnet_tpu_torch.models.convert import params_from_numpy
    from ncnet_tpu_torch.models.ncnet import tree_leaves, tree_map

    kw = dict(backbone=backbone, ncons_kernel_sizes=kernels,
              ncons_channels=channels, relocalization_k_size=reloc)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = params_from_numpy(jax.tree.map(
            np.asarray, jax_tool("make_goldens").deterministic_params(
                JConfig(**kw))))
    got = port_tool("make_goldens").deterministic_params(ModelConfig(**kw))
    assert len(tree_leaves(got)) == len(tree_leaves(want))
    tree_map(lambda a, b: np.testing.assert_array_equal(a.numpy(), b.numpy()),
             got, want)


@pytest.fixture(scope="module")
def golden_record(tmp_path_factory):
    """The port's ``make_goldens --out --check`` on the CPU: its exit code,
    what it printed and its record."""
    import contextlib
    import io

    out = str(tmp_path_factory.mktemp("goldens") / "record.npz")
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = port_tool("make_goldens").main(
            ["--out", out, "--check", "--device", "cpu"])
    return rc, text.getvalue(), dict(np.load(out))


def test_make_goldens_check_passes_on_the_cpu(golden_record):
    tool = port_tool("make_goldens")
    rc, text, rec = golden_record
    assert rc == 0
    assert "17/17 keys within tolerance" in text
    golden = np.load(tool.GOLDEN)
    assert sorted(rec) == sorted(golden.files)
    for k in golden.files:
        np.testing.assert_allclose(rec[k], golden[k], **FWD_TOL)


def test_make_goldens_check_fails_on_a_perturbed_golden(golden_record):
    tool = port_tool("make_goldens")
    golden = dict(np.load(tool.GOLDEN))
    golden["tiny_corr"] = golden["tiny_corr"] + 1e-3
    del golden["p3p_pts"]
    rows = {r["key"]: r for r in tool.check(golden_record[2], golden)}
    assert [k for k, r in rows.items() if not r["ok"]] == ["tiny_corr"]
    assert rows["tiny_corr"]["atol_needed"] > 9e-4
    golden["dsift_img"] = golden["dsift_img"][:3]  # a shape that differs
    assert not {r["key"]: r for r in tool.check(
        golden_record[2], golden)}["dsift_img"]["ok"]
    with pytest.raises(SystemExit):
        tool.main(["--device", "cpu"])  # neither --out nor --check


# ---------------------------------------------------------------------------
# parity_kit
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def torch_ckpt(tmp_path_factory):
    """tests/test_parity_kit.py's reference-format .pth.tar: a
    Sequential-indexed ResNet-101 trunk, one pre-permuted Conv4d layer and
    the argparse args the reference stores."""
    from test_backbone import make_resnet101_state_dict

    rng = np.random.default_rng(0)
    name_to_idx = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5",
                   "layer3": "6"}
    sd = {}
    for k, v in make_resnet101_state_dict().items():
        name, _, tail = k.partition(".")
        sd[f"FeatureExtraction.model.{name_to_idx[name]}.{tail}"] = \
            torch.tensor(v)
    w = rng.standard_normal((3, 3, 3, 3, 1, 1)).astype(np.float32) * 0.2
    sd["NeighConsensus.conv.0.weight"] = torch.tensor(
        np.transpose(w, (0, 5, 4, 1, 2, 3)))
    sd["NeighConsensus.conv.0.bias"] = torch.tensor(np.zeros(1, np.float32))
    path = tmp_path_factory.mktemp("ckpt") / "synthetic_ncnet.pth.tar"
    torch.save({"state_dict": sd, "args": argparse.Namespace(
        ncons_kernel_sizes=[3], ncons_channels=[1],
        feature_extraction_cnn="resnet101")}, str(path))
    return str(path)


@pytest.fixture(scope="module")
def pf_root(tmp_path_factory):
    """The JAX writer's PF-Pascal-like split, with the raw images the port
    reads beside its JPEGs (ROADMAP D1)."""
    from ncnet_tpu.data.synthetic import write_pf_pascal_like
    from ncnet_tpu_torch.tools.convert_images import convert_tree

    root = str(tmp_path_factory.mktemp("pf"))
    write_pf_pascal_like(root, n_pairs=2, image_hw=(96, 96), shift=(16, 16))
    convert_tree(root)
    return root


def test_pck_command_matches_the_jax_kit(torch_ckpt, pf_root, capsys):
    argv = ["--torch_checkpoint", torch_ckpt, "--dataset", pf_root,
            "--image_size", "64", "--quiet"]
    assert jax_tool("parity_kit").main(argv) == 0
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("PCK:")]
    assert port_tool("parity_kit").main(argv + ["--device", "cpu"]) == 0
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("PCK:")]
    assert got == want and "2/2 valid" in got[0]


def test_all_runbook(torch_ckpt, pf_root, capsys, monkeypatch):
    tool = port_tool("parity_kit")
    base = ["--all", "--pfpascal_checkpoint", torch_ckpt, "--ivd_checkpoint",
            "", "--image_size", "64", "--quiet", "--device", "cpu"]
    assert tool.main(base + ["--dataset", pf_root]) == 0
    out = capsys.readouterr().out
    assert "twin activation check" in out and "PASS" in out
    assert "PCK@0.1" in out and "78.9%" in out
    assert "arch: backbone=resnet101" in out
    assert "[ivd] no checkpoint given" in out
    with pytest.raises(SystemExit):
        tool.main(["--all", "--pfpascal_checkpoint", "/nonexistent/x.pth.tar",
                   "--device", "cpu"])
    # the gates, with the twin check and the eval already held above
    monkeypatch.setattr(tool, "twin_activation_check", lambda *a, **k: True)
    monkeypatch.setattr(tool, "run_pck", lambda *a, **k: {
        "pck": 0.5, "valid": 2, "total": 2})
    assert tool.main(base + ["--dataset", pf_root,
                             "--expect_pck", "101.0"]) == 1
    assert tool.main(base + ["--dataset", pf_root,
                             "--expect_pck", "50.0"]) == 0
    assert tool.main(base + ["--expect_pck", "50.0"]) == 1
    assert "never ran" in capsys.readouterr().out


def test_traces_diff_across_packages(torch_ckpt, pf_root, tmp_path, capsys):
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    argv = ["--torch_checkpoint", torch_ckpt, "--dataset", pf_root,
            "--image_size", "64", "--pairs", "2"]
    assert jax_tool("parity_kit").main(argv + ["--record_trace", theirs]) == 0
    assert port_tool("parity_kit").main(
        argv + ["--record_trace", ours, "--device", "cpu"]) == 0
    a, b = np.load(ours), np.load(theirs)
    assert sorted(a.files) == sorted(b.files)
    assert all(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
               for k in a.files)
    for tool in (port_tool("parity_kit"), jax_tool("parity_kit")):
        assert tool.main(["--compare", ours, theirs, "--tolerance",
                          "1e-4"]) == 0
        assert tool.main(["--compare", theirs, ours, "--tolerance",
                          "1e-4"]) == 0
    capsys.readouterr()
    tool = port_tool("parity_kit")
    arrays = {k: a[k].copy() for k in a.files}
    arrays["corr_filtered_1"] = arrays["corr_filtered_1"] + 1.0
    bad = str(tmp_path / "perturbed.npz")
    np.savez_compressed(bad, **arrays)
    assert tool.main(["--compare", theirs, bad, "--tolerance", "0.1"]) == 1
    assert "corr_filtered_1" in capsys.readouterr().out
    trunc = str(tmp_path / "trunc.npz")
    np.savez_compressed(trunc, **{k: a[k] for k in a.files
                                  if k.startswith("feature")})
    assert tool.main(["--compare", theirs, trunc]) == 1
    assert tool.main(["--compare", theirs, trunc, "--allow_missing"]) == 0


# ---------------------------------------------------------------------------
# the reference twin
# ---------------------------------------------------------------------------


def test_reference_twin_equals_the_test_twins():
    from test_backbone import make_resnet101_state_dict
    from test_inloc_match_parity import torch_corr_to_matches, torch_maxpool4d
    from test_torch_parity import torch_full_forward

    from ncnet_tpu_torch.tools import reference_twin as twin

    rng = np.random.default_rng(3)
    sd = make_resnet101_state_dict()
    layers = [(torch.from_numpy(rng.normal(0, 0.1, s).astype(np.float32)),
               torch.from_numpy(rng.normal(0, 0.02, s[0]).astype(np.float32)))
              for s in ((4, 1, 3, 3, 3, 3), (1, 4, 3, 3, 3, 3))]
    src = torch.from_numpy(rng.normal(0, 1, (1, 3, 48, 48)).astype(np.float32))
    tgt = torch.from_numpy(rng.normal(0, 1, (1, 3, 32, 48)).astype(np.float32))
    with torch.no_grad():
        want = torch_full_forward(sd, layers, src, tgt)
        got = twin.torch_full_forward(sd, layers, src, tgt)
    assert torch.equal(got, want)
    fine = torch.from_numpy(
        rng.normal(0, 1, (1, 1, 6, 4, 4, 6)).astype(np.float32))
    pooled = twin.torch_maxpool4d(fine, 2)
    for a, b in zip(pooled, torch_maxpool4d(fine, 2)):
        assert torch.equal(a, b)
    for inv in (False, True):
        for kw in (dict(do_softmax=True), dict(delta4d=pooled[1:], k_size=2)):
            vol = pooled[0] if "delta4d" in kw else fine
            want = torch_corr_to_matches(vol, invert_matching_direction=inv,
                                         **kw)
            got = twin.torch_corr_to_matches(vol,
                                             invert_matching_direction=inv,
                                             **kw)
            for a, b in zip(got, want):
                assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the refusal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,argv", [
    ("make_goldens", ["--check"]),
    ("parity_kit", ["--all", "--pfpascal_checkpoint", __file__]),
])
def test_repo_tools_need_cuda_unless_told_cpu(name, argv):
    if torch.cuda.is_available():
        pytest.skip("the refusal shows only where CUDA is not available")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_tool(name).main(argv)
