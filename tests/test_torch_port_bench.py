"""The port's bench (``ncnet_tpu_torch/tools/bench.py``) on the CPU, and
bench-artefact ingestion against the JAX package's.

  * ``--device cpu --tiny`` over the core sections prints one JSON line of
    the root bench's shape with finite values, records into the store it
    is given, and never touches the committed ``perf/history.jsonl``;
  * every ``extra`` name is one of the root ``bench.py``'s (read from its
    source), or one of the documented renames; every root name is in the
    port's source but the left-out MFU block's;
  * the quality section on a numpy-seeded tiny pair, with the JAX weights
    carried across (``models/convert.py::params_from_numpy``), gives the
    JAX ``quality_table`` values (rtol 1e-5, atol 1e-7: the eval step's
    quality columns in ``test_torch_port_eval.py``) and tiers;
  * a section that raises, or leaves a metric that is not finite, exits 1,
    is named in ``failed``, and the other sections' metrics still print;
  * the roofline block's counts are the shared work functions';
  * each committed ``BENCH_r*.json`` (read only) ingested by both packages
    gives the same records, and both ``perf_regress`` CLIs seeded from the
    same files give the same exit codes and ``--check --json`` findings.
"""

import contextlib
import glob
import hashlib
import io
import json
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ncnet_tpu import config as jcfg
from ncnet_tpu.models import ncnet as jnet
from ncnet_tpu.observability import perfstore as jps
from ncnet_tpu.observability import quality as jquality
from ncnet_tpu_torch import config as tcfg
from ncnet_tpu_torch.models.convert import params_from_numpy
from ncnet_tpu_torch.observability import metrics as tmetrics
from ncnet_tpu_torch.observability import perfstore as tps
from ncnet_tpu_torch.observability import roofline
from ncnet_tpu_torch.tools import bench
from torch_port_tool_twins import REPO, jax_tool, port_tool

HISTORY = os.path.join(REPO, "perf", "history.jsonl")
ARTEFACTS = sorted(glob.glob(os.path.join(REPO, "BENCH_r*.json")))
CORE = "forward,quality,stages,filter,memory,corr,baseline"

# the names that differ from the root's on purpose (the module docstring)
RENAMES = {"roofline_filter_mxu_bound_ms":
           "roofline_filter_tensor_core_bound_ms",
           "roofline_filter_pct_of_mxu_bound":
           "roofline_filter_pct_of_tensor_core_bound"}
# the MFU block of XLA's cost analysis, and the device kind it set (the
# envelope carries it)
LEFT_OUT = {"forward_bf16_mfu_pct", "forward_bf16_mfu_executed_pct",
            "forward_bf16_tflops", "device_kind"}
# keys of the JSON line and of run_eval's result, not metrics
NOT_METRICS = {"metric", "value", "unit", "vs_baseline", "extra",
               "envelope", "timing", "total"}


def sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def run_bench(argv):
    """``bench.main(argv)`` → (exit code, the parsed JSON line, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench.main(argv)
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 1, out.getvalue()
    return rc, json.loads(lines[0]), err.getvalue()


@pytest.fixture(scope="module")
def core_run(tmp_path_factory):
    """The core sections once, at ``--tiny`` on the CPU, into a store of
    the test's own; the committed history's bytes before and after."""
    store = str(tmp_path_factory.mktemp("bench") / "store.jsonl")
    before = sha(HISTORY)
    rc, line, err = run_bench(["--device", "cpu", "--tiny", "--only", CORE,
                               "--store", store])
    return {"rc": rc, "line": line, "err": err, "store": store,
            "history": (before, sha(HISTORY))}


def test_core_sections_print_the_roots_line(core_run):
    rc, line = core_run["rc"], core_run["line"]
    assert rc == 0, core_run["err"]
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "extra",
                         "envelope", "sections"}
    assert line["metric"] == "pf_pascal_forward_ms_per_pair"
    assert line["unit"] == "ms/pair"
    assert math.isfinite(line["value"]) and line["value"] > 0
    assert math.isfinite(line["vs_baseline"]) and line["vs_baseline"] > 0
    extra = line["extra"]
    numeric = {k: v for k, v in extra.items() if not isinstance(v, str)}
    assert all(isinstance(v, (int, float)) and math.isfinite(v)
               for v in numeric.values()), numeric
    for name in ("forward_ms_per_pair_bf16", "filter_ms_per_pair_bf16",
                 "corr_ms_per_pair", "forward_ms_per_pair_bs1",
                 "forward_wall_ms_per_pair_bs1", "torch_cpu_ms_per_pair_bs1",
                 "filter_stage_stack_prefix3_ms", "quality_score_bf16"):
        assert name in extra, name
    # the CPU measures no device memory, and the tiny trunk's 8⁴ volume
    # takes the FFT tier as 25⁴ does
    assert not any(k.startswith("mem_") for k in extra)
    assert extra["filter_stage_tier"] == extra["quality_tier_bf16"] == "fft"
    assert list(line["sections"]) == CORE.split(",")
    for entry in line["sections"].values():
        assert entry["wall_s"] >= 0 and entry["launches"] == {
            "nc_conv4d_bf16": 0, "gather_tile_corr_bf16": 0,
            "conv4d_small_cout": 0, "nc_vjp": 0}
    assert "device_kind" not in line["envelope"]  # no card in use


def test_bench_records_into_the_named_store_only(core_run, tmp_path,
                                                 monkeypatch):
    """The named store holds every numeric metric (the headline and
    ``vs_baseline`` included) under ``source="bench"``; with no store named
    nothing is recorded, and the committed history is byte-identical."""
    recs = tps.PerfStore(core_run["store"]).records()
    extra = core_run["line"]["extra"]
    want = {k for k, v in extra.items() if not isinstance(v, str)}
    want |= {"pf_pascal_forward_ms_per_pair", "vs_baseline"}
    assert {r["metric"] for r in recs} == want
    assert {r["source"] for r in recs} == {"bench"}
    assert {r["device_kind"] for r in recs} == {"cpu"}
    assert core_run["history"][0] == core_run["history"][1]
    monkeypatch.delenv("NCNET_TPU_PERF_STORE", raising=False)
    monkeypatch.chdir(tmp_path)
    before = sha(HISTORY)
    rc, line, err = run_bench(["--device", "cpu", "--tiny", "--only",
                               "quality"])
    assert rc == 0 and "nothing recorded" in err
    assert line["value"] is None and line["vs_baseline"] is None
    assert sha(HISTORY) == before
    assert "NCNET_TPU_PERF_STORE" not in os.environ
    assert os.listdir(tmp_path) == []


def _templates(names):
    """Root names as regexes: an f-string's fields match any word."""
    return [re.compile(re.sub(r"\\\{[^}]*\\\}", r"\\w+", re.escape(n)) + "$")
            for n in names]


def root_metric_names():
    """The metric names the root ``bench.py`` assigns: ``res[...]`` /
    ``out[...]`` / ``vals[...]`` keys, ``put(...)`` names, the keys of its
    result dicts, and the fold pair's names (f-strings as templates)."""
    with open(os.path.join(REPO, "bench.py")) as f:
        src = f.read()
    names = set(re.findall(r'(?:res|out|vals)\[f?"([^"]+)"\]', src))
    names |= set(re.findall(r'put\(\s*f?"([^"]+)"', src))
    names |= set(re.findall(r'^\s*"([a-z0-9_]+)": ', src, re.M))
    names |= set(re.findall(r'\{f"([^"]+)":', src))
    names |= set(re.findall(r'\("(train_step_ms_bf16_\w+)", (?:True|False)\)',
                            src))
    return names - NOT_METRICS


def test_extra_names_are_the_roots(core_run):
    names = root_metric_names()
    assert len(names) > 60 and "quality_{name}_{suffix}" in names
    allowed = _templates(names) + _templates(RENAMES.values())
    for key in core_run["line"]["extra"]:
        assert any(p.match(key) for p in allowed), key
    # the other direction, in the source: every root name the port emits
    # appears there (a template by its fixed head)
    with open(bench.__file__) as f:
        port_src = f.read()
    for name in sorted(names - LEFT_OUT):
        name = RENAMES.get(name, name)
        head = name.split("{")[0]
        assert (f'"{name}"' in port_src if "{" not in name
                else f'f"{head}' in port_src), name
    body = port_src.split('"""', 2)[2]  # the code, past the docstring
    for name in LEFT_OUT:
        assert f'res["{name}"]' not in body and (
            name == "device_kind" or name not in body), name
    assert "roofline_verdict" in body and "mxu" not in body


def test_quality_section_matches_jax():
    """fp32 signals of one numpy-seeded pair through the tiny trunk and the
    PF-Pascal stack (a 4⁴ volume, which the FFT gate refuses), the JAX
    weights carried across; the fp32 tier equals JAX's, the bf16 one is
    the port chooser's."""
    kw = dict(backbone="tiny", ncons_kernel_sizes=bench.KERNELS,
              ncons_channels=bench.CHANNELS)
    jc, tc = jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)
    jp = jnet.init_ncnet(jc, jax.random.key(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(7)
    src, tgt = (rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
                for _ in range(2))
    for half, suffix in ((False, "fp32"), (True, "bf16")):
        jcf = jc.replace(half_precision=half, backbone_bf16=half)
        tcf = tc.replace(half_precision=half, backbone_bf16=half)
        want = np.asarray(jax.jit(lambda s, t: jquality.quality_table(
            jnet.ncnet_forward(jcf, jp, s, t).corr))(
                jnp.asarray(src), jnp.asarray(tgt)))
        want_tier = jquality.active_tier(half)
        with torch.no_grad():
            got = bench.quality_values(tcf, tp, torch.from_numpy(src),
                                       torch.from_numpy(tgt), suffix)
        # fp32 never takes the kernel tier; bf16 does in the port, whose
        # chooser offers B6 on any device (the CPU runs its twin), where
        # the JAX chooser's Pallas gates refuse a CPU backend
        assert got.pop(f"quality_tier_{suffix}") == (
            "resident" if half else want_tier)
        assert want_tier == "xla"
        assert list(got) == [f"quality_{n}_{suffix}"
                             for n in jquality.QUALITY_SIGNALS]
        if not half:
            np.testing.assert_allclose(np.array(list(got.values())),
                                       want[0], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("fault", ["raises", "not_finite"])
def test_failed_section_is_named_and_exits_1(fault, tmp_path, monkeypatch):
    def broken(bx):
        if fault == "raises":
            raise RuntimeError("injected section failure")
        bx.res["filter_stage_tier"] = "fft"
        bx.res["filter_stage_layer1_ms"] = float("nan")

    monkeypatch.setitem(bench.SECTIONS, "stages", broken)
    store = str(tmp_path / "store.jsonl")
    rc, line, err = run_bench(["--device", "cpu", "--tiny", "--only",
                               "quality,stages,filter", "--store", store])
    assert rc == 1
    assert line["failed"] == ["stages"]
    assert "bench: section stages failed" in err
    assert ("injected section failure" if fault == "raises"
            else "not finite") in err
    extra = line["extra"]
    assert "quality_score_fp32" in extra and "filter_ms_per_pair_bf16" in extra
    # what the failed section left that is finite stays; the rest is named
    assert "filter_stage_layer1_ms" not in extra
    assert ("filter_stage_tier" in extra) == (fault == "not_finite")
    assert set(line["sections"]) == {"quality", "stages", "filter"}
    recorded = {r["metric"] for r in tps.PerfStore(store).records()}
    assert "filter_ms_per_pair_bf16" in recorded
    assert "filter_stage_layer1_ms" not in recorded


def test_roofline_block_counts_are_the_work_functions():
    """At 25⁴, batch 4, C = 1024 on the card's peaks: 4 · 119⁴ · 288 FLOP a
    pair (231.0 GFLOP), the stack's and the filter's bytes a pair, the
    bounds at the peaks, the verdict, and the every-tap MFU numerator."""
    k, c = bench.KERNELS, bench.CHANNELS
    out = bench.roofline_metrics(filter_ms=8.0, forward_bf16_ms=16.0,
                                 batch=4, side=25, feat_channels=1024,
                                 peak_tflops=989.0, peak_gbps=3350.0)
    flops, _ = roofline.stack_work((8, 25, 25, 25, 25), k, c)
    assert flops / 4 == 4 * 119 ** 4 * 288
    assert out["roofline_filter_gflops_per_pair"] == pytest.approx(231.015,
                                                                   abs=1e-3)
    assert out["roofline_filter_gflops_per_pair"] * 1e9 == flops / 4
    tc_ms = flops / 4 / roofline.PEAK_BF16_FLOPS * 1e3
    assert out["roofline_filter_tensor_core_bound_ms"] == pytest.approx(tc_ms)
    _, nbytes = roofline.filter_work(4, 25, 1024, k, c)
    assert nbytes == (2 * 4 * 4 * 625 * 1024
                      + 2 * (625 * 16 + 16 + 625 * 256 + 16 + 625 * 16 + 1)
                      + 2 * 4 * 25 ** 4)
    assert out["roofline_filter_hbm_bound_ms"] == pytest.approx(
        nbytes / 4 / roofline.PEAK_HBM_BYTES_PER_S * 1e3)
    stack_bytes = roofline.stack_work((8, 25, 25, 25, 25), k, c)[1]
    assert out["roofline_filter_hbm_algorithmic_ms"] == pytest.approx(
        stack_bytes / 4 / roofline.PEAK_HBM_BYTES_PER_S * 1e3)
    assert out["roofline_filter_pct_of_tensor_core_bound"] == pytest.approx(
        100 * tc_ms / 8.0)
    assert out["roofline_verdict"] == "tensor_core-lowering-bound"
    every_tap = tmetrics.filter_flops(25, k, c)
    assert every_tap == pytest.approx(281.25e9)
    assert out["filter_bf16_mfu_algorithmic_pct"] == pytest.approx(
        100 * every_tap / 8e-3 / 989e12)
    assert out["forward_bf16_mfu_algorithmic_pct"] == pytest.approx(
        100 * every_tap / 16e-3 / 989e12)
    assert "forward_bf16_mfu_algorithmic_pct" not in bench.roofline_metrics(
        8.0, None, 4, 25, 1024, 989.0, 3350.0)


@pytest.mark.parametrize("path", ARTEFACTS,
                         ids=[os.path.basename(p) for p in ARTEFACTS])
def test_bench_artefact_ingests_alike(path, tmp_path):
    assert ARTEFACTS
    before = sha(path)
    j_store = jps.PerfStore(str(tmp_path / "jax.jsonl"))
    t_store = tps.PerfStore(str(tmp_path / "port.jsonl"))
    n_j = jps.ingest_bench_artifact(j_store, path)
    n_t = tps.ingest_bench_artifact(t_store, path)
    assert n_j == n_t
    assert t_store.records() == j_store.records()
    if n_j:  # a failed round printed no metric line: no store is written
        with open(j_store.path, "rb") as a, open(t_store.path, "rb") as b:
            assert a.read() == b.read()
    else:
        assert not os.path.exists(j_store.path)
        assert not os.path.exists(t_store.path)
    assert sha(path) == before


def _main(tool, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = tool.main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("check", [[], ["--metrics",
                                        "pf_pascal_forward_ms_per_pair"]])
def test_perf_regress_seed_agrees_with_jax(check, tmp_path):
    """Both CLIs seeded from every committed artefact into fresh stores:
    the same exit codes and counts, the same stores; then ``--check
    --json``: the same exit code and findings (the store paths aside)."""
    jp, tp = jax_tool("perf_regress"), port_tool("perf_regress")
    got = {}
    for name, tool in (("jax", jp), ("port", tp)):
        store = str(tmp_path / f"{name}.jsonl")
        rc, _, err = _main(tool, ["--seed", *ARTEFACTS, "--store", store])
        seeded = re.findall(r"seeded (\d+) record", err)
        rc_c, out, _ = _main(tool, ["--check", "--json", "--store", store,
                                    *check])
        doc = json.loads(out)
        got[name] = (rc, seeded, rc_c, doc["findings"],
                     tps.PerfStore(store).records())
    assert got["jax"] == got["port"]
    rc, seeded, rc_c, findings, records = got["port"]
    assert rc == 0 and len(seeded) == len(ARTEFACTS) and records
    assert rc_c in (0, 1) and findings
