"""The port's utils/misc.py vs phiseg_tpu/utils/misc.py, function for function.

Both are numpy: results are held equal bit for bit. The NIfTI helpers need
nibabel and histogram_equalization needs cv2; each test of them skips where
its package is absent.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from phiseg_tpu.utils import misc as jm
from phiseg_tpu_torch.utils import misc as tm

torch.set_num_threads(1)
RNG = np.random.RandomState(0)
IMGS = RNG.randn(3, 9, 7).astype(np.float32) * 4 + 1
LBL = RNG.randint(0, 3, (2, 6, 5))


def _eq(a, b):
    if isinstance(b, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b or (np.isnan(a) and np.isnan(b))


def test_same_functions():
    names = lambda m: sorted(n for n in vars(m) if not n.startswith("_") and  # noqa: E731
                             callable(vars(m)[n]) and getattr(vars(m)[n], "__module__", "") == m.__name__)
    assert names(tm) == names(jm)


@pytest.mark.parametrize("name,args", [
    ("convert_to_onehot", (LBL[0], 3)),
    ("convert_batch_to_onehot", (LBL, 3)),
    ("ncc", (IMGS[0], IMGS[1])),
    ("ncc", (IMGS[0], IMGS[1], False)),
    ("norm_l2", (IMGS[0], IMGS[2])),
    ("jaccard_onehot", ((IMGS[0] > 1).astype(float), (IMGS[1] > 1).astype(float))),
    ("all_argmax", (IMGS[0],)),
    ("all_argmax", (LBL[0], 0)),
    ("find_floor_in_list", ([0, 10, 50, 100], 57)),
    ("list_mean", ([1.0, 2.5, 4.0],)),
    ("convert_to_uint8", (IMGS[0],)),
    ("convert_to_uint8_rgb_fixed", (np.tanh(IMGS[0]),)),
    ("normalise_image", (IMGS[0],)),
    ("normalise_images", (IMGS,)),
    ("map_image_to_intensity_range", (IMGS[0], -1.0, 1.0, 5)),
    ("map_images_to_intensity_range", (IMGS, 0.0, 1.0)),
    ("softmax", (IMGS,)),
])
def test_function_matches_jax(name, args):
    want, got = getattr(jm, name)(*args), getattr(tm, name)(*args)
    if isinstance(want, tuple):
        for a, b in zip(got, want, strict=True):
            _eq(a, b)
    else:
        _eq(got, want)


def test_find_floor_raises_like_jax():
    for m in (jm, tm):
        with pytest.raises(ValueError, match="all elements larger"):
            m.find_floor_in_list([5, 6], 1)


def test_makefolder_and_bunch(tmp_path):
    d = str(tmp_path / "a" / "b")
    assert tm.makefolder(d) is True and os.path.isdir(d) and tm.makefolder(d) is False
    b = tm.Bunch(x=1, y="z")
    assert (b.x, b.y) == (1, "z") and vars(b) == vars(jm.Bunch(x=1, y="z"))


def test_histogram_equalization_matches_jax():
    if importlib.util.find_spec("cv2") is None:
        pytest.skip("cv2 is not installed")
    img = (RNG.rand(16, 16, 3) * 255).astype(np.uint8)
    _eq(tm.histogram_equalization(img), jm.histogram_equalization(img))


def test_nifti_round_trip_matches_jax(tmp_path):
    if importlib.util.find_spec("nibabel") is None:
        pytest.skip("nibabel is not installed")
    data = IMGS.transpose(1, 2, 0)
    tm.create_and_save_nii(data, str(tmp_path / "a.nii.gz"))
    jm.create_and_save_nii(data, str(tmp_path / "b.nii.gz"))
    (ta, taff, thdr), (ja, jaff, _) = tm.load_nii(str(tmp_path / "a.nii.gz")), \
        jm.load_nii(str(tmp_path / "b.nii.gz"))
    _eq(ta, ja)
    _eq(taff, jaff)
    tm.save_nii(str(tmp_path / "c.nii.gz"), ta, taff, thdr)
    _eq(tm.load_nii(str(tmp_path / "c.nii.gz"))[0], ja)
