"""The port's LIDC data path vs phiseg_tpu's, on the CPU, on a fake pickle.

The pickle has the structure of Stefan Knegt's LIDC crops (a dict of
{image, masks[4], series_uid}, as tests/test_data.py writes it). Both
packages are numpy + h5py here, so their caches and batches are held equal
bit for bit. Then a tiny phiseg_7_5 trains through the port's train CLI on
`--data lidc` and test_quantitative scores it.
"""

import json
import os
import pickle
import sys

import h5py
import numpy as np
import pytest
import torch

from phiseg_tpu.data.lidc import LIDCData as JaxLIDCData
from phiseg_tpu.data.lidc import prepare_data as jax_prepare_data
from phiseg_tpu.experiments import get_experiment as jax_get_experiment
from phiseg_tpu_torch.cli.test_quantitative import main as quant_main
from phiseg_tpu_torch.cli.train import main as train_main
from phiseg_tpu_torch.data import get_dataset
from phiseg_tpu_torch.data.lidc import (
    LIDCData,
    _read_pickle_chunked,
    crop_or_pad_slice_to_size,
    prepare_data,
    split_lidc,
)
from phiseg_tpu_torch.experiments import get_experiment, list_experiments

torch.set_num_threads(1)
HW = 32
LIDC_EXPERIMENTS = [n for n in list_experiments() if get_experiment(n).data_identifier == "lidc"]


def _write_fake_lidc_pickle(path, n_patients=10, lesions_per_patient=3, hw=HW):
    """{lesion id: {'image', 'masks' (4 discs, radius by annotator), 'series_uid'}}."""
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[:hw, :hw]
    data, k = {}, 0
    for p in range(n_patients):
        for _ in range(lesions_per_patient):
            cy, cx, r = rng.uniform(hw / 3, 2 * hw / 3, 2).tolist() + [rng.uniform(2, hw / 5)]
            masks = [(((yy - cy) ** 2 + (xx - cx) ** 2) < (r + a - 1.5) ** 2).astype(np.uint8)
                     for a in range(4)]
            data[k] = {"image": np.clip(rng.rand(hw, hw) * 0.3 + 0.5 * masks[1], 0, 0.999),
                       "masks": masks, "series_uid": f"1.3.6.1.4.{p:04d}"}
            k += 1
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return data


@pytest.fixture(scope="module")
def lidc(tmp_path_factory):
    root = tmp_path_factory.mktemp("lidc")
    pkl = str(root / "data_lidc.pickle")
    raw = _write_fake_lidc_pickle(pkl)
    for name in ("jax", "port"):
        os.makedirs(root / name)
    jax_prepare_data(pkl, str(root / "jax" / "data_lidc.hdf5"))
    prepare_data(pkl, str(root / "port" / "data_lidc.hdf5"))
    return {"pickle": pkl, "raw": raw, "root": root}


def test_prepare_data_writes_the_jax_cache_bit_for_bit(lidc):
    with h5py.File(lidc["root"] / "jax" / "data_lidc.hdf5", "r") as fj, \
            h5py.File(lidc["root"] / "port" / "data_lidc.hdf5", "r") as fp:
        assert list(fp) == list(fj) == ["test", "train", "val"]
        for split in fj:
            assert sorted(fp[split]) == sorted(fj[split]) == ["images", "labels", "uids"]
            for key in fj[split]:
                a, b = fp[split][key][()], fj[split][key][()]
                assert a.dtype == b.dtype and a.shape == b.shape, (split, key)
                assert a.tobytes() == b.tobytes(), (split, key)


def test_split_lidc_contract(lidc):
    """The contract of tests/test_data.py:283-320 on the in-memory split:
    shapes, dtypes, the -0.5 offset, every lesion once, disjoint patients."""
    splits = split_lidc(_read_pickle_chunked(lidc["pickle"]))
    assert sum(s["images"].shape[0] for s in splits.values()) == len(lidc["raw"])
    uids = {}
    for name, s in splits.items():
        assert s["images"].shape[1:] == (HW, HW) and s["images"].dtype == np.float64
        assert s["labels"].shape[1:] == (HW, HW, 4) and s["labels"].dtype == np.uint8
        assert s["uids"].dtype == np.int64 and s["uids"].shape[0] == s["images"].shape[0]
        assert -0.5 <= s["images"].min() and s["images"].max() < 0.5
        uids[name] = set(s["uids"].tolist())
    assert not (uids["train"] & uids["val"]) and not (uids["train"] & uids["test"]) \
        and not (uids["val"] & uids["test"])
    assert [len(uids[n]) for n in ("test", "val", "train")] == [2, 2, 6]


def test_crop_or_pad_slice_to_size():
    sl = np.arange(20.0).reshape(4, 5)
    out = crop_or_pad_slice_to_size(sl, 6, 3)
    assert out.shape == (6, 3)
    np.testing.assert_array_equal(out[1:5], sl[:, 1:4])
    assert not out[0].any() and not out[5].any()


def _assert_batches_equal(a, b):
    for u, v in zip(a, b, strict=True):
        assert u.dtype == v.dtype
        np.testing.assert_array_equal(u, v)


def _assert_datasets_equal(tdata, jdata):
    """next_batch and iterate_batches of all three providers, and the raw
    validation / test arrays."""
    for split in ("train", "validation", "test"):
        tp, jp = getattr(tdata, split), getattr(jdata, split)
        for _ in range(3):
            _assert_batches_equal(tp.next_batch(4), jp.next_batch(4))
        for tb, jb in zip(tp.iterate_batches(5), jp.iterate_batches(5), strict=True):
            _assert_batches_equal(tb, jb)
    for split in ("validation", "test"):
        for key in ("images", "labels"):
            np.testing.assert_array_equal(np.asarray(getattr(getattr(tdata, split), key)),
                                          np.asarray(getattr(getattr(jdata, split), key)))


@pytest.mark.parametrize("name", ["phiseg_7_5", "detunet"])  # annotators (0,1,2,3) and (0,)
def test_each_package_reads_the_others_cache(lidc, name):
    cfg, jcfg = get_experiment(name), jax_get_experiment(name)
    root = lidc["root"]
    _assert_datasets_equal(LIDCData(cfg, lidc["pickle"], str(root / "jax"), seed=3),
                           JaxLIDCData(jcfg, lidc["pickle"], str(root / "port"), seed=3))
    if cfg.annotator_range == (0,):  # annotator 0 is every label
        x, y = LIDCData(cfg, lidc["pickle"], str(root / "jax")).validation.next_batch(4)
        assert y.shape == (4, HW, HW) and x.shape == (4, HW, HW, 1) and x.dtype == np.float32


@pytest.mark.parametrize("host_augment", [False, True])
def test_in_memory_dataset_equals_the_cached_one(lidc, host_augment):
    cfg = get_experiment("phiseg_7_5")
    splits = split_lidc(_read_pickle_chunked(lidc["pickle"]))
    mem = LIDCData.from_splits(cfg, splits, host_augment=host_augment, seed=1)
    cached = LIDCData(cfg, lidc["pickle"], str(lidc["root"] / "port"),
                      host_augment=host_augment, seed=1)
    assert mem.train.do_augmentations == host_augment
    assert mem.validation.images is splits["val"]["images"]
    _assert_datasets_equal(mem, cached)


def test_host_augmented_lidc_batches_are_bitwise_jax(lidc):
    cfg, jcfg = get_experiment("phiseg_7_5"), jax_get_experiment("phiseg_7_5")
    root = lidc["root"]
    tdata = LIDCData(cfg, lidc["pickle"], str(root / "port"), host_augment=True, seed=2)
    jdata = JaxLIDCData(jcfg, lidc["pickle"], str(root / "jax"), host_augment=True, seed=2)
    for _ in range(3):
        _assert_batches_equal(tdata.train.next_batch(6), jdata.train.next_batch(6))


def test_cache_without_h5py_raises_importerror(lidc, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="needs h5py.*from_splits"):
        LIDCData(get_experiment("phiseg_7_5"), lidc["pickle"], str(lidc["root"] / "port"))


@pytest.mark.parametrize("name", LIDC_EXPERIMENTS)
def test_get_dataset_takes_the_lidc_branch(lidc, name, tmp_path, monkeypatch):
    """Every registry entry on LIDC gets its dataset from PHISEG_DATA_ROOT,
    cached under PHISEG_PREPROC_ROOT."""
    monkeypatch.setenv("PHISEG_DATA_ROOT", lidc["pickle"])
    monkeypatch.setenv("PHISEG_PREPROC_ROOT", str(tmp_path / "preproc"))
    cfg = get_experiment(name)
    data = get_dataset(cfg, seed=5)
    assert isinstance(data, LIDCData)
    assert os.path.exists(tmp_path / "preproc" / "data_lidc.hdf5")
    x, s = data.train.next_batch(cfg.batch_size)
    assert x.shape == (cfg.batch_size, HW, HW, 1) and s.shape == (cfg.batch_size, HW, HW)


def test_tiny_phiseg_7_5_trains_on_lidc_through_the_cli_and_is_scored(lidc, tmp_path,
                                                                       monkeypatch):
    monkeypatch.setenv("PHISEG_DATA_ROOT", lidc["pickle"])
    monkeypatch.setenv("PHISEG_PREPROC_ROOT", str(tmp_path / "preproc"))
    cfg = get_experiment("phiseg_7_5").replace(
        resolution_levels=5, latent_levels=3, n0=4, image_size=(HW, HW, 1), batch_size=4,
        compute_dtype="float32", validation_frequency=2, validation_samples=3,
        validation_elbo_samples=2, tensorboard_update_frequency=1,
        do_image_summaries=False, do_histogram_summaries=False)
    path, log_dir = str(tmp_path / "cfg.json"), str(tmp_path / "log")
    cfg.save(path)
    trainer = train_main([path, "--data", "lidc", "--num-iter", "3", "--log-dir", log_dir,
                          "--device", "cpu"])
    assert trainer.state.step == 3
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    val = [r for r in recs if "validation_GED" in r]
    assert [r["step"] for r in val] == [2] and np.isfinite(val[0]["validation_GED"])
    n_test = 6  # 2 test patients x 3 lesions
    ged, ncc = quant_main([log_dir, "--samples", "4", "--batch", "4", "--device", "cpu"])
    assert ged.shape == ncc.shape == (n_test,) and np.isfinite(ged).all()
    with np.load(os.path.join(log_dir, "ged4_best_ged.npz")) as z:
        assert int(z["n_annotators"]) == 4 and z["arr_0"].shape == (n_test,)
