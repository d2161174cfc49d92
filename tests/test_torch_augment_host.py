"""The port's host-side augmentation and batch provider vs phiseg_tpu's, on the CPU.

Both are numpy/scipy, so the same inputs and the same RandomState give
bitwise-equal batches and leave the RandomState in the same state.
"""

import numpy as np
import pytest
import torch

from phiseg_tpu.data.augment_host import augment_batch_host as jax_augment
from phiseg_tpu.data.batch_provider import BatchProvider as JaxBatchProvider
from phiseg_tpu.data.synthetic import SyntheticData as JaxSyntheticData
from phiseg_tpu.experiments import get_experiment as jax_get_experiment
from phiseg_tpu_torch.data.augment_host import augment_batch_host
from phiseg_tpu_torch.data.batch_provider import BatchProvider
from phiseg_tpu_torch.data.synthetic import SyntheticData
from phiseg_tpu_torch.experiments import get_experiment

torch.set_num_threads(1)
OPTIONS = ("do_rotations", "do_scaleaug", "do_elasticaug", "do_fliplr", "do_flipud")


def _batch(seed, b=4, hw=24, nlabels=2):
    rng = np.random.RandomState(seed)
    x = rng.rand(b, hw, hw, 1).astype(np.float32)
    yy, xx = np.mgrid[:hw, :hw]
    y = np.stack([((yy - hw / 2 - i) ** 2 + (xx - hw / 2) ** 2 < (hw / 4) ** 2) * (i % nlabels)
                  for i in range(b)]).astype(np.int32)
    return x, y


def _same_state(a: np.random.RandomState, b: np.random.RandomState):
    for u, v in zip(a.get_state(), b.get_state()):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("options", [(o,) for o in OPTIONS] + [OPTIONS])
def test_augment_batch_host_is_bitwise_jax(options, seed):
    x, y = _batch(seed)
    opts = {o: True for o in options}
    opts.update(augment_every_nth=1 if seed else 2, rot_degrees=15.0, offset=6, nlabels=2)
    r_jax, r_port = np.random.RandomState(seed), np.random.RandomState(seed)
    want_x, want_y = jax_augment(x, y, opts, r_jax)
    got_x, got_y = augment_batch_host(x, y, opts, r_port)
    assert got_x.dtype == want_x.dtype and got_y.dtype == want_y.dtype
    np.testing.assert_array_equal(got_x, want_x)
    np.testing.assert_array_equal(got_y, want_y)
    _same_state(r_port, r_jax)


AUG = {"do_rotations": True, "do_scaleaug": True, "do_elasticaug": True,
       "do_flip_lr": True, "do_flip_ud": True, "augment_every_nth": 2, "offset": 6}


@pytest.mark.parametrize("annotators", [(0, 1, 2, 3), (0,)])
def test_batch_provider_with_host_augmentation_is_bitwise_jax(annotators):
    """next_batch and iterate_batches with augmentation, resize and
    annotator picks: equal batches and RandomState; the reference config's
    flip keys (do_flip_lr / do_flip_ud) are canonicalised on both sides."""
    rng = np.random.RandomState(5)
    images = rng.rand(10, 20, 20).astype(np.float64) - 0.5
    labels = (rng.rand(10, 20, 20, 4) > 0.7).astype(np.uint8)
    kw = dict(num_labels_per_subject=4, annotator_range=annotators, do_augmentations=True,
              augmentation_options=AUG, resize_to=(24, 24), seed=3)
    jp = JaxBatchProvider(images, labels, np.arange(10), **kw)
    tp = BatchProvider(images, labels, np.arange(10), **kw)
    for _ in range(4):
        for a, b in zip(tp.next_batch(3), jp.next_batch(3)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    for tb, jb in zip(tp.iterate_batches(4), jp.iterate_batches(4), strict=True):
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a, b)
    _same_state(tp.rng, jp.rng)
    np.testing.assert_array_equal(tp.indices, np.arange(10))  # iteration never mutates it


def test_synthetic_data_host_augment_is_bitwise_jax():
    name = "phiseg_7_5_synth"
    kw = dict(n_train=8, n_val=2, n_test=2, host_augment=True, seed=4)
    cfg = get_experiment(name).replace(image_size=(32, 32, 1))
    jcfg = jax_get_experiment(name).replace(image_size=(32, 32, 1))
    tdata, jdata = SyntheticData(cfg, **kw), JaxSyntheticData(jcfg, **kw)
    assert tdata.train.do_augmentations and not tdata.validation.do_augmentations
    for _ in range(3):
        for a, b in zip(tdata.train.next_batch(4), jdata.train.next_batch(4)):
            np.testing.assert_array_equal(a, b)
    _same_state(tdata.train.rng, jdata.train.rng)
