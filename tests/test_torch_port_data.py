"""The port's data path against the JAX package on the CPU: the synthetic
PF-Pascal writer, the raw image form (ROADMAP decision D1) and its
converter, ``PFPascalDataset`` and the loader.

Everything here is exact: the same numpy code on the same pixels.  The
JAX side writes JPEGs and decodes them with PIL; ``tools/convert_images``
turns the same JPEGs into the raw files the port reads, so both datasets
see PIL's pixels.  The port's fixture writer reproduces PIL's bilinear
resize in numpy, so its images equal the JAX ``make_shifted_pair``'s.
"""

import os
import threading

import numpy as np
import pytest
from PIL import Image

from ncnet_tpu.data import DataLoader as JaxLoader
from ncnet_tpu.data import PFPascalDataset as JaxPFPascal
from ncnet_tpu.data import datasets as jdatasets
from ncnet_tpu.data import synthetic as jsynth
from ncnet_tpu_torch.data import (
    DataLoader,
    PFPascalDataset,
    SampleDecodeError,
    default_collate,
    load_image,
)
from ncnet_tpu_torch.data import datasets as tdatasets
from ncnet_tpu_torch.data import synthetic as tsynth
from ncnet_tpu_torch.tools import convert_images
from ncnet_tpu_torch.utils import faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_CSV = os.path.join(REPO, "datasets", "pf-pascal", "image_pairs",
                        "test_pairs.csv")

# (image_hw, shift, n_points, seed): the JAX default, the eval-loop phase's
# 300 x 500 pairs, negative and zero shifts, extra random keypoints
FIXTURES = [
    ((96, 128), (16, 16), 6, 0),
    ((300, 500), (12, 20), 6, 1),
    ((64, 80), (-8, 16), 4, 2),
    ((40, 48), (0, -8), 8, 3),
]


@pytest.fixture(autouse=True)
def _no_faults():
    faults.clear()
    yield
    faults.clear()


@pytest.fixture(scope="module")
def jpeg_root(tmp_path_factory):
    """A JAX-written PF-Pascal-like tree (JPEGs), converted to raw files."""
    root = str(tmp_path_factory.mktemp("pf"))
    jsynth.write_pf_pascal_like(root, n_pairs=4, image_hw=(72, 88),
                                shift=(16, -8), n_points=7, seed=5)
    assert convert_images.main([root]) == 0
    return root


@pytest.mark.parametrize("size", [(2, 2, 16, 16), (12, 16, 96, 128),
                                  (40, 68, 300, 500), (13, 7, 57, 71),
                                  (9, 4, 9, 4)])
def test_pil_bilinear_resize_is_pils(size):
    h, w, out_h, out_w = size
    low = np.random.default_rng(h * w).uniform(0, 255, (h, w, 3)).astype(np.uint8)
    want = np.asarray(Image.fromarray(low).resize((out_w, out_h), Image.BILINEAR))
    np.testing.assert_array_equal(tsynth.pil_bilinear_resize(low, out_w, out_h),
                                  want)


@pytest.mark.parametrize("hw,shift,n_points,seed", FIXTURES)
def test_make_shifted_pair_equals_jax(hw, shift, n_points, seed):
    jrng, trng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(2):  # the generators stay in step across pairs
        for a, b in zip(jsynth.make_shifted_pair(jrng, *hw, shift),
                        tsynth.make_shifted_pair(trng, *hw, shift)):
            assert a.dtype == b.dtype == np.uint8
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hw,shift,n_points,seed", FIXTURES)
def test_write_pf_pascal_like_equals_jax(tmp_path, hw, shift, n_points, seed):
    """The CSV is byte-equal to the JAX writer's and each raw image is the
    JAX ``make_shifted_pair``'s pixel array for the same generator."""
    kw = dict(n_pairs=3, image_hw=hw, shift=shift, n_points=n_points, seed=seed)
    jcsv = jsynth.write_pf_pascal_like(str(tmp_path / "jax"), **kw)
    tcsv = tsynth.write_pf_pascal_like(str(tmp_path / "port"), **kw)
    assert os.path.relpath(tcsv, tmp_path / "port") == os.path.join(
        "image_pairs", "test_pairs.csv")
    with open(jcsv, "rb") as f, open(tcsv, "rb") as g:
        assert f.read() == g.read()
    rng = np.random.default_rng(seed)
    for i in range(3):
        src, tgt = jsynth.make_shifted_pair(rng, *hw, shift)
        if n_points > 4:
            rng.uniform(0.1, 0.9, (n_points - 4, 2))
        for img, side in ((src, "a"), (tgt, "b")):
            path = tmp_path / "port" / "images" / f"test_{i}_{side}.jpg"
            assert not path.exists()  # the raw form only
            np.testing.assert_array_equal(np.load(f"{path}.npy"), img)
            np.testing.assert_array_equal(load_image(str(path)), img)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("procedure", ["pf", "scnet"])
@pytest.mark.parametrize("size", [(64, 80), (96, 96)])
def test_dataset_equals_jax_on_converted_jpegs(jpeg_root, normalize, procedure,
                                               size):
    csv = os.path.join(jpeg_root, "image_pairs", "test_pairs.csv")
    kw = dict(output_size=size, normalize=normalize, pck_procedure=procedure)
    jds, tds = JaxPFPascal(csv, jpeg_root, **kw), PFPascalDataset(csv, jpeg_root, **kw)
    assert len(jds) == len(tds) == 4
    for i in range(len(jds)):
        a, b = jds[i], tds[i]
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_dataset_category_filter_equals_jax(jpeg_root):
    csv = os.path.join(jpeg_root, "image_pairs", "test_pairs.csv")
    jds = JaxPFPascal(csv, jpeg_root, category=1)
    tds = PFPascalDataset(csv, jpeg_root, category=1)
    assert tds.img_a_names == jds.img_a_names and len(tds) == 2  # pairs 0, 3
    np.testing.assert_array_equal(tds.category, jds.category)
    np.testing.assert_array_equal(tds[1]["target_points"], jds[1]["target_points"])


def test_vendored_test_csv_parses_as_the_jax_package():
    """Every row of the vendored PF-Pascal test split: names, classes and
    the parsed (2, 20) keypoint tables equal the JAX (pandas) parse."""
    jds = JaxPFPascal(TEST_CSV, os.path.dirname(os.path.dirname(TEST_CSV)))
    tds = PFPascalDataset(TEST_CSV, os.path.dirname(os.path.dirname(TEST_CSV)))
    assert len(tds) == len(jds) == 299
    assert tds.img_a_names == jds.img_a_names
    assert tds.img_b_names == jds.img_b_names
    np.testing.assert_array_equal(tds.category, jds.category)
    for i in range(len(tds)):
        for t_pts, j_pts in ((tds.point_a[i], jds.point_a), (tds.point_b[i], jds.point_b)):
            want = jdatasets._parse_points(j_pts.iloc[i, 0], j_pts.iloc[i, 1])
            np.testing.assert_array_equal(tdatasets._parse_points(*t_pts), want)


def test_convert_images_modes_and_reruns(tmp_path):
    """Grayscale and RGBA images convert to what the JAX loader makes of
    them; existing raw files are kept unless --overwrite; an undecodable
    image fails the run (exit 1) and writes nothing."""
    rng = np.random.default_rng(0)
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    Image.fromarray(rng.integers(0, 256, (9, 11), dtype=np.uint8)).save(img_dir / "g.png")
    Image.fromarray(rng.integers(0, 256, (7, 5, 4), dtype=np.uint8)).save(img_dir / "a.png")
    Image.fromarray(rng.integers(0, 256, (6, 8, 3), dtype=np.uint8)).save(
        img_dir / "c.jpg", quality=90)
    (tmp_path / "notes.txt").write_text("not an image")
    res = convert_images.convert_tree(str(tmp_path))
    assert len(res["written"]) == 3 and not res["failed"] and not res["kept"]
    for name in ("g.png", "a.png", "c.jpg"):
        path = str(img_dir / name)
        got = load_image(path)
        assert got.dtype == np.uint8 and got.shape[2] == 3
        np.testing.assert_array_equal(got, jdatasets.load_image(path))
    assert not (tmp_path / "notes.txt.npy").exists()
    assert convert_images.convert_tree(str(tmp_path))["kept"] == sorted(
        str(img_dir / n) for n in ("a.png", "c.jpg", "g.png"))
    assert len(convert_images.convert_tree(str(tmp_path), overwrite=True)["written"]) == 3
    (img_dir / "bad.jpg").write_bytes(b"\xff\xd8garbage")
    assert convert_images.main([str(tmp_path)]) == 1
    assert not (img_dir / "bad.jpg.npy").exists()


def test_load_image_retry_and_decode_errors(tmp_path):
    path = str(tmp_path / "x.jpg")
    np.save(path + ".npy", np.zeros((4, 5, 3), np.uint8))
    # a transient injected fault is absorbed by the retry budget
    with faults.injected(faults.FaultPlan(decode_fail_substring="x.jpg",
                                          decode_fail_times=1)):
        assert tdatasets.load_image_with_retry(path, 1).shape == (4, 5, 3)
    with faults.injected(faults.FaultPlan(decode_fail_substring="x.jpg")):
        with pytest.raises(SampleDecodeError) as e:
            tdatasets.load_image_with_retry(path, 2)
    assert e.value.path == path + ".npy"
    # a raw file of the wrong type, a corrupt one and a missing one
    np.save(path + ".npy", np.zeros((4, 5, 3), np.float32))
    with pytest.raises(SampleDecodeError, match="uint8"):
        tdatasets.load_image_with_retry(path, 0)
    with open(path + ".npy", "wb") as f:
        f.write(b"\x93NUMPYgarbage")
    with pytest.raises(SampleDecodeError):
        tdatasets.load_image_with_retry(path, 0)
    with pytest.raises(SampleDecodeError):
        tdatasets.load_image_with_retry(str(tmp_path / "missing.jpg"), 0)


# ---------------------------------------------------------------------------
# the loader: the cases of tests/test_data.py, on the port's dataset
# ---------------------------------------------------------------------------


class ArrayDataset:
    """Seeded in-memory samples (image + a scalar + a name)."""

    def __init__(self, n=5, side=8):
        rng = np.random.default_rng(n)
        self.images = rng.uniform(0, 1, (n, side, side, 3)).astype(np.float32)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return {"source_image": self.images[i], "n": i, "name": f"s{i}"}


@pytest.fixture(scope="module")
def pf_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pf_raw"))
    tsynth.write_pf_pascal_like(root, n_pairs=5, image_hw=(48, 48), seed=9)
    return root


def pf_dataset(root, size=32):
    return PFPascalDataset(os.path.join(root, "image_pairs", "test_pairs.csv"),
                           root, output_size=(size, size))


def test_loader_batching_and_collate(pf_root):
    ds = pf_dataset(pf_root)
    loader = DataLoader(ds, batch_size=2)
    batches = list(loader)
    assert len(loader) == len(batches) == 3
    assert batches[0]["source_image"].shape == (2, 32, 32, 3)
    assert batches[0]["source_points"].shape == (2, 2, 20)
    assert batches[-1]["source_image"].shape == (1, 32, 32, 3)
    loader_dl = DataLoader(ds, batch_size=2, drop_last=True)
    assert len(list(loader_dl)) == len(loader_dl) == 2


def test_loader_shuffle_deterministic_epoch_keyed_and_the_jax_order():
    ds = ArrayDataset(n=11)
    l1 = DataLoader(ds, batch_size=5, shuffle=True, seed=7)
    l2 = DataLoader(ds, batch_size=5, shuffle=True, seed=7)
    b1, b2 = next(iter(l1)), next(iter(l2))
    np.testing.assert_array_equal(b1["source_image"], b2["source_image"])
    l2.set_epoch(1)
    b3 = next(iter(l2))
    assert not np.array_equal(b1["source_image"], b3["source_image"])
    for epoch in (0, 1, 4):
        t = DataLoader(ds, batch_size=3, shuffle=True, seed=7)
        j = JaxLoader(ds, batch_size=3, shuffle=True, seed=7)
        t.set_epoch(epoch)
        j.set_epoch(epoch)
        np.testing.assert_array_equal(t._epoch_indices(), j._epoch_indices())


def test_loader_sharding_disjoint():
    ds = ArrayDataset(n=5)
    idx0 = DataLoader(ds, batch_size=2, num_shards=2, shard_index=0, shuffle=True,
                      seed=3)._epoch_indices()
    idx1 = DataLoader(ds, batch_size=2, num_shards=2, shard_index=1, shuffle=True,
                      seed=3)._epoch_indices()
    assert len(idx0) == len(idx1) == 2
    assert set(idx0.tolist()).isdisjoint(idx1.tolist())
    with pytest.raises(ValueError, match="shard_index"):
        DataLoader(ds, batch_size=2, num_shards=2, shard_index=2)


def test_loader_prefetch_matches_sync(pf_root):
    ds = pf_dataset(pf_root, size=24)
    sync = list(DataLoader(ds, batch_size=2, num_workers=0))
    pre = list(DataLoader(ds, batch_size=2, num_workers=2))
    assert len(sync) == len(pre) == 3
    for a, b in zip(sync, pre):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_loader_propagates_worker_errors():
    class Boom:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise RuntimeError("decode failed")

    with pytest.raises(RuntimeError, match="decode failed"):
        list(DataLoader(Boom(), batch_size=2, num_workers=2))


def test_collate_mixed_types():
    batch = default_collate(
        [{"a": np.zeros((2, 2)), "s": "x", "n": 1}, {"a": np.ones((2, 2)), "s": "y", "n": 2}])
    assert batch["a"].shape == (2, 2, 2)
    assert batch["s"] == ["x", "y"]
    np.testing.assert_array_equal(batch["n"], [1, 2])


def test_loader_early_break_no_deadlock():
    """Abandoning a prefetching iterator must stop the producer thread."""
    ds = ArrayDataset(n=6)
    before = threading.active_count()
    for _ in range(3):
        for batch in DataLoader(ds, batch_size=1, num_workers=2, prefetch_batches=1):
            break  # abandon mid-epoch
    assert threading.active_count() <= before + 1


def test_loader_mid_epoch_resume_skips_batches():
    ds = ArrayDataset(n=7)
    full = list(DataLoader(ds, batch_size=2, shuffle=True, seed=1))
    loader = DataLoader(ds, batch_size=2, shuffle=True, seed=1)
    loader.set_epoch(0, start_batch=2)
    rest = list(loader)
    assert len(loader) == 4 and len(rest) == 2
    for a, b in zip(full[2:], rest):
        np.testing.assert_array_equal(a["n"], b["n"])


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_quarantine_substitutes_and_reports(pf_root, workers):
    """A corrupt raw image: 'raise' propagates it, 'quarantine' substitutes
    the next healthy sample (index-deterministic), reports the raw file
    and the sample's index; the substitute is sample 2's own."""
    ds = pf_dataset(pf_root)
    clean = list(DataLoader(ds, batch_size=2))
    bad = os.path.join(pf_root, "images", "test_1_b.jpg.npy")
    good = np.load(bad)
    try:
        with open(bad, "wb") as f:
            f.write(b"not an array")
        with pytest.raises(SampleDecodeError):
            list(DataLoader(ds, batch_size=2, num_workers=workers))
        loader = DataLoader(ds, batch_size=2, num_workers=workers,
                            on_decode_error="quarantine")
        batches = list(loader)
        assert loader.quarantined == {bad} and loader.bad_indices == {1}
        np.testing.assert_array_equal(batches[0]["source_image"][1],
                                      batches[1]["source_image"][0])
        np.testing.assert_array_equal(batches[0]["source_image"][0],
                                      clean[0]["source_image"][0])
        np.testing.assert_array_equal(batches[2]["L_pck"], clean[2]["L_pck"])
    finally:
        np.save(bad, good)


def test_loader_systemic_decode_failure_raises(pf_root):
    """Every image failing is a wrong root, not a corrupt file: the scan
    for a substitute gives up instead of quarantining the whole set."""
    ds = pf_dataset(pf_root)
    loader = DataLoader(ds, batch_size=1, on_decode_error="quarantine")
    with faults.injected(faults.FaultPlan(decode_fail_substring="images/")):
        with pytest.raises(SampleDecodeError, match="no decodable sample"):
            list(loader)
    assert loader.bad_indices == set(range(5))
    with pytest.raises(ValueError, match="on_decode_error"):
        DataLoader(ds, batch_size=1, on_decode_error="skip")
