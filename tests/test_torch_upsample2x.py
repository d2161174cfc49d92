"""The x2 bilinear upsample op (phiseg_tpu_torch/ops/upsample_bilinear2x.py)
on the CPU: its plain forward against F.interpolate and against the JAX
package's resize, the memory format of its output, its plain gather
backward against autograd of F.interpolate, gradcheck of the Function, the
wrapper's checks, and nn.layers routing through it without a launch.

The CUDA kernels run only on a card (chip_smoke.py phase 2b holds them
against these plain versions there). Tolerances: against F.interpolate in
f64, two ulps of the terms' magnitude (the same upsample of |x|), since the
two sum the same products in an order that differs only by fused
multiply-adds; against JAX in f32, 1e-6 (jax.image.resize applies its
weights as a matrix product).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from phiseg_tpu.nn import layers as jl
from phiseg_tpu_torch.nn import layers as tl
from phiseg_tpu_torch.ops import upsample_bilinear2x as up2

torch.set_num_threads(1)

SHAPES = [(2, 3, 5, 6), (2, 2, 8, 8), (1, 1, 1, 1), (2, 2, 1, 7), (2, 2, 7, 1), (3, 1, 4, 9),
          (2, 192, 4, 4), (1, 2, 3, 2)]
FORMATS = {"nchw": torch.contiguous_format, "channels_last": torch.channels_last}


def _x(shape, dtype=torch.float64, fmt="nchw", seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(*shape)).to(dtype)
    return x.contiguous(memory_format=FORMATS[fmt])


def _interp(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forward_matches_f_interpolate_f64(shape, fmt):
    x = _x(shape, fmt=fmt)
    got, want = up2.upsample2x_plain(x), _interp(x)
    terms = up2.upsample2x_plain(x.abs())
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert ((got - want).abs() <= 2 * torch.finfo(torch.float64).eps * terms).all()


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_jax_resize_f32(shape, fmt):
    x = _x(shape, torch.float32, fmt, seed=1)
    want = np.asarray(jl.upsample_bilinear(jnp.asarray(x.permute(0, 2, 3, 1).numpy()), 2))
    got = up2.upsample_bilinear2x(x)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forward_bf16_rounds_once_like_f_interpolate(shape):
    """In bf16 the products and the row sums are exact in f32, so one
    rounding of the f32 result gives F.interpolate's bits."""
    x = _x(shape, torch.bfloat16, seed=2)
    assert torch.equal(up2.upsample2x_plain(x), _interp(x))


def _layouts():
    """Inputs in the layouts the op meets: each format, a channel slice of
    each (strided), the NHWC view of a C=1 image (contiguous and
    channels_last at once), and (N,1,1,1)."""
    x = _x((2, 4, 5, 6))
    cl = x.contiguous(memory_format=torch.channels_last)
    one = torch.randn(2, 5, 6, 1, dtype=torch.float64).permute(0, 3, 1, 2)
    return {"nchw": x, "channels_last": cl, "nchw slice": x[:, ::2], "cl slice": cl[:, 1:3],
            "c1 nhwc view": one, "n111": torch.randn(3, 1, 1, 1, dtype=torch.float64),
            "transposed hw": x.transpose(2, 3)}


@pytest.mark.parametrize("name", list(_layouts()))
def test_output_keeps_the_memory_format_f_interpolate_gives(name):
    x = _layouts()[name]
    got, want = up2.upsample_bilinear2x(x), _interp(x)
    assert got.stride() == want.stride()
    assert up2.memory_format(got) == up2.memory_format(want) == up2.memory_format(x)
    terms = up2.upsample2x_plain(x.abs())
    assert ((got - want).abs() <= 2 * torch.finfo(torch.float64).eps * terms).all()


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("shape", SHAPES)
def test_gather_backward_matches_autograd_of_f_interpolate_f64(shape, fmt):
    x = _x(shape, fmt=fmt, seed=3).requires_grad_(True)
    g = _x((shape[0], shape[1], 2 * shape[2], 2 * shape[3]), seed=4)
    (want,) = torch.autograd.grad(_interp(x), x, g)
    (got,) = torch.autograd.grad(up2.upsample_bilinear2x(x), x, g)
    assert got.shape == x.shape and up2.memory_format(got) == up2.memory_format(x)
    mag = up2.upsample2x_gather_plain(g.abs())
    assert ((got - want).abs() <= 4 * torch.finfo(torch.float64).eps * mag).all()
    assert torch.equal(up2.upsample2x_gather_plain(g), got.contiguous())


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (2, 2, 3, 4), (1, 3, 1, 5), (1, 2, 4, 1)])
def test_gradcheck_of_the_op(shape, fmt):
    x = _x(shape, fmt=fmt, seed=5).requires_grad_(True)
    assert torch.autograd.gradcheck(up2.upsample_bilinear2x, (x,))


@pytest.mark.parametrize("dtype", [torch.float16, torch.int32, torch.int64, torch.complex64])
def test_unsupported_dtype_raises(dtype):
    with pytest.raises(TypeError, match="bfloat16, float32 or float64"):
        up2.upsample_bilinear2x(torch.zeros(1, 1, 2, 2, dtype=dtype))


def test_non_4d_input_raises():
    with pytest.raises(ValueError, match=r"\(N,C,H,W\)"):
        up2.upsample_bilinear2x(torch.zeros(1, 2, 2))


def test_empty_batch_gives_an_empty_output():
    y = up2.upsample_bilinear2x(torch.zeros(0, 3, 4, 5))
    assert y.shape == (0, 3, 8, 10)


def test_layers_route_factor_2_through_the_op_and_launch_nothing_on_the_cpu(monkeypatch):
    calls = []
    real = tl.upsample_bilinear2x

    def spy(x):
        calls.append(tuple(x.shape))
        return real(x)

    monkeypatch.setattr(tl, "upsample_bilinear2x", spy)
    up2.reset_launch_counts()
    x = _x((2, 3, 4, 5), torch.float32).requires_grad_(True)
    y = tl.upsample_bilinear(x, 2)
    y.square().sum().backward()
    assert calls == [(2, 3, 4, 5)] and x.grad.shape == x.shape
    assert up2.LAUNCHES == {"upsample2x_fwd": 0, "upsample2x_bwd": 0}
    with pytest.raises(ValueError, match="factor of 2"):
        tl.upsample_bilinear(x.detach(), 3)
    assert calls == [(2, 3, 4, 5)]
