"""The eval-mode BatchNorm + ReLU epilogue (phiseg_tpu_torch/ops/bn_act_eval.py)
and its dispatch in the conv blocks (nn/layers.py `_Normalised._norm_act`).

On the CPU: the plain version is the blocks' chain bit for bit; the
dispatch predicate takes the kernel only for an eval-mode batch norm with
ReLU or no activation on a bf16 / f32 CUDA tensor with no gradient wanted;
a BN'd block's eval output on the CPU is the chain's; the wrapper's layout
and checks. The CUDA cases (marker `cuda`) skip without a card; on one they
hold the kernel to the plain chain (at least 99.9% of elements bitwise, the
rest within one ulp of the output dtype), its in-place write, and its
launches on the sampler and train paths:

  python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_bn_act_eval.py -q
"""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from phiseg_tpu_torch.nn import layers
from phiseg_tpu_torch.ops import bn_act_eval as ba

torch.set_num_threads(1)

FORMATS = {"nchw": torch.contiguous_format, "channels_last": torch.channels_last}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
ACTS = {"relu": F.relu, "none": None}


def _stats(c, seed=0, device="cpu"):
    """(running_mean, running_var, weight, bias), f32, away from the identity."""
    rng = np.random.RandomState(seed)
    mean, var = rng.randn(c) * 0.5, rng.rand(c) * 2.0 + 0.05
    weight, bias = rng.randn(c), rng.randn(c) * 0.5
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device)
                 for a in (mean, var, weight, bias))


def _x(shape, dtype, fmt=torch.contiguous_format, seed=1, device="cpu"):
    x = torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32) * 2.0)
    return x.to(device=device, dtype=dtype).contiguous(memory_format=fmt)


def _bn_block(norm="batch", activation=F.relu, dtype=torch.bfloat16, c=6, seed=0):
    """An eval-mode ConvBlock whose BN holds `_stats`."""
    blk = layers.ConvBlock(3, c, activation=activation, norm=norm, dtype=dtype).eval()
    with torch.no_grad():
        for t, v in zip((blk.bn.running_mean, blk.bn.running_var, blk.bn.weight, blk.bn.bias),
                        _stats(c, seed)):
            t.copy_(v)
    return blk


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm", ["batch", "batch_bf16"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_plain_version_is_the_block_tail_bit_for_bit(fmt, dtype, act, norm):
    blk = _bn_block(norm, ACTS[act], DTYPES[dtype])
    x = _x((2, 6, 5, 7), DTYPES[dtype], FORMATS[fmt])
    with torch.no_grad():
        want = blk._normalise(x)
        want = (want if ACTS[act] is None else ACTS[act](want)).to(DTYPES[dtype])
        got = ba.bn_act_eval_plain(x, blk.bn.running_mean, blk.bn.running_var, blk.bn.weight,
                                   blk.bn.bias, layers.BN_EPS, relu=act == "relu")
    assert got.dtype == want.dtype and torch.equal(got, want)


def _cuda_like(dtype=torch.bfloat16, requires_grad=False, is_cuda=True):
    """What the predicate reads of the conv's output, as a CUDA tensor has it."""
    return types.SimpleNamespace(is_cuda=is_cuda, dtype=dtype, requires_grad=requires_grad)


def _takes(blk, x, grad=False):
    with torch.set_grad_enabled(grad):
        return blk._takes_bn_act_kernel(x)


@pytest.mark.parametrize("case", [
    "batch_relu", "batch_none", "batch_bf16_relu", "f32", "grad_on_nothing_requires_grad",
    "transposed", "conv3d",
])
def test_predicate_takes_the_kernel(case):
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    if case in ("transposed", "conv3d"):
        cls = layers.TransposedConvBlock if case == "transposed" else layers.Conv3DBlock
        blk = cls(3, 4, norm="batch", dtype=dtype).eval()
    else:
        norm = "batch_bf16" if case == "batch_bf16_relu" else "batch"
        blk = _bn_block(norm, None if case == "batch_none" else F.relu, dtype)
    grad = case == "grad_on_nothing_requires_grad"
    if grad:
        blk.requires_grad_(False)
    assert _takes(blk, _cuda_like(dtype), grad)


@pytest.mark.parametrize("case", [
    "training", "grad_on_params_require_grad", "grad_on_input_requires_grad", "softplus",
    "f64", "group", "renorm", "none_norm", "cpu", "autocast_dtype", "transposed_training",
])
def test_predicate_takes_the_chain(case):
    dtype = {"f64": torch.float64}.get(case, torch.bfloat16)
    x = _cuda_like(dtype, requires_grad=case == "grad_on_input_requires_grad",
                   is_cuda=case != "cpu")
    if case in ("group", "renorm", "none_norm"):
        blk = layers.ConvBlock(3, 6, norm={"none_norm": "none"}.get(case, case),
                               dtype=dtype).eval()
    elif case == "transposed_training":
        blk = layers.TransposedConvBlock(3, 4, norm="batch", dtype=dtype).train()
    else:
        blk = _bn_block("batch", F.softplus if case == "softplus" else F.relu,
                        torch.float32 if case == "autocast_dtype" else dtype)
        if case == "training":
            blk.train()
    if case == "grad_on_input_requires_grad":
        blk.requires_grad_(False)
    grad = case.startswith("grad_on")
    assert not _takes(blk, x, grad)


@pytest.mark.parametrize("cls", ["ConvBlock", "TransposedConvBlock", "DilatedConvBlock",
                                 "Conv3DBlock"])
@pytest.mark.parametrize("act", ACTS)
def test_bn_block_eval_output_on_cpu_is_the_chain(cls, act):
    """On the CPU the blocks run the chain: the conv, F.batch_norm in f32,
    the activation, the cast; no launch."""
    block_cls = getattr(layers, cls)
    blk = block_cls(3, 6, activation=ACTS[act], norm="batch", dtype=torch.bfloat16).eval()
    with torch.no_grad():
        for t, v in zip((blk.bn.running_mean, blk.bn.running_var, blk.bn.weight, blk.bn.bias),
                        _stats(6)):
            t.copy_(v)
    shape = (2, 3, 4, 6, 6) if cls == "Conv3DBlock" else (2, 3, 8, 8)
    x = _x(shape, torch.float32)
    ba.reset_launch_counts()
    with torch.no_grad():
        got = blk(x)
        conv = blk.conv_module if cls != "ConvBlock" else blk.conv
        y = (blk._conv(x.to(torch.bfloat16), conv.weight.to(torch.bfloat16))
             if cls != "ConvBlock" else
             F.conv2d(x.to(torch.bfloat16), conv.weight.to(torch.bfloat16), padding=1))
        y = F.batch_norm(y.float(), blk.bn.running_mean, blk.bn.running_var, blk.bn.weight,
                         blk.bn.bias, training=False, eps=layers.BN_EPS)
        want = (y if ACTS[act] is None else ACTS[act](y)).to(torch.bfloat16)
    assert torch.equal(got, want)
    assert ba.LAUNCHES == {"bn_act_eval": 0}


@pytest.mark.parametrize("form,want", [
    ("nchw", (1, 12, 35)), ("channels_last", (0, 70, 6)), ("ncdhw", (1, 12, 70)),
    ("channels_last_3d", (0, 140, 6)), ("strided", None), ("c1_channels_last", (1, 2, 35)),
])
def test_layout_of_each_memory_format(form, want):
    shape = (2, 6, 2, 5, 7) if "dhw" in form or form.endswith("3d") else (2, 6, 5, 7)
    if form == "c1_channels_last":
        shape = (2, 1, 5, 7)
    fmt = {"channels_last": torch.channels_last, "channels_last_3d": torch.channels_last_3d,
           "c1_channels_last": torch.channels_last}.get(form, torch.contiguous_format)
    x = torch.zeros(shape).contiguous(memory_format=fmt)
    if form == "strided":
        x = torch.zeros(2, 12, 5, 7)[:, ::2]
    assert ba.layout(x) == want


@pytest.mark.parametrize("what", ["cpu_tensor", "f64_cpu"])
def test_wrapper_refuses_cpu_tensors(what):
    dtype = torch.float64 if what == "f64_cpu" else torch.bfloat16
    x = _x((2, 6, 4, 4), dtype)
    before = x.clone()
    ba.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        ba.bn_act_eval(x, *_stats(6), layers.BN_EPS, relu=True)
    assert torch.equal(x, before) and ba.LAUNCHES["bn_act_eval"] == 0


# ---------------------------------------------------------------------------
# CUDA
# ---------------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the bn_act_eval kernel)")


_MANTISSA = {torch.bfloat16: 8, torch.float32: 24}


def _plain(x, stats, relu):
    """The plain chain on x; for channels_last x with PyTorch's own BN
    kernel (cuDNN off): cuDNN's NHWC kernel, which the chain reaches there,
    rounds its per-channel terms otherwise than its NCHW kernel and
    PyTorch's, whose rounding the kernel has (in f32 it differs from them
    in the last bit on some channels)."""
    layout = ba.layout(x)
    with torch.backends.cudnn.flags(enabled=layout is None or layout[0] == 1):
        return ba.bn_act_eval_plain(x, *stats, layers.BN_EPS, relu)


def _agreement(got, want):
    """(share of elements bitwise equal, largest difference in ulps of the
    output dtype at |want|)."""
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    g, w = got.double(), want.double()
    _, e = torch.frexp(w.abs().clamp_min(torch.finfo(want.dtype).tiny))
    ulp = torch.ldexp(torch.ones_like(w), e - _MANTISSA[want.dtype])
    diff = torch.where(same, torch.zeros_like(g), (g - w).abs() / ulp)
    return same.double().mean().item(), diff.max().item()


# the eval's BN'd calls at fewer rows: 128x128 (32 channels), 64x64, 32x32,
# the 4x4 and 2x2 levels (192 channels), and an odd plane (the scalar path)
EVAL_SHAPES = [(16, 32, 128, 128), (16, 64, 64, 64), (16, 192, 32, 32), (64, 192, 4, 4),
               (64, 192, 2, 2), (8, 40, 5, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", EVAL_SHAPES)
def test_cuda_kernel_matches_plain_chain(shape, dtype, fmt):
    _need_cuda()
    dt = DTYPES[dtype]
    stats = _stats(shape[1], device="cuda")
    for relu in (True, False):
        x = _x(shape, dt, FORMATS[fmt], device="cuda")
        want = _plain(x, stats, relu)
        got = ba.bn_act_eval(x, *stats, layers.BN_EPS, relu)
        torch.cuda.synchronize()
        share, ulps = _agreement(got, want)
        assert got.data_ptr() == x.data_ptr() and got.dtype == dt
        assert share >= 0.999 and ulps <= 1, (shape, dtype, fmt, relu, share, ulps)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["misaligned_nchw", "misaligned_channels_last", "strided",
                                  "ncdhw", "channels_last_3d", "nan_and_inf"])
def test_cuda_kernel_edge_inputs(case):
    _need_cuda()
    dt = torch.bfloat16
    if case.startswith("misaligned"):
        fmt = torch.channels_last if case.endswith("last") else torch.contiguous_format
        base = _x((4, 16, 8, 8), dt, fmt, device="cuda")
        buf = torch.empty(base.numel() + 3, dtype=dt, device="cuda")[3:]
        x = buf.as_strided(base.shape, base.stride()).copy_(base)
        assert ba.width(x) == 1
    elif case == "strided":
        x = _x((4, 32, 8, 8), dt, device="cuda")[:, ::2]
    elif case == "ncdhw":
        x = _x((2, 16, 4, 8, 8), torch.float32, device="cuda")
    elif case == "channels_last_3d":
        x = _x((2, 16, 4, 8, 8), dt, torch.channels_last_3d, device="cuda")
    else:
        x = _x((2, 16, 8, 8), torch.float32, device="cuda")
        x[0, 0, 0, :4] = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0])
    stats = _stats(x.shape[1], device="cuda")
    want = _plain(x, stats, True)
    got = ba.bn_act_eval(x, *stats, layers.BN_EPS, True)
    torch.cuda.synchronize()
    share, ulps = _agreement(got, want)
    assert share >= 0.999 and ulps <= 1, (case, share, ulps)
    if case == "strided":
        assert got.is_contiguous()


@pytest.mark.cuda
def test_cuda_in_place_write_leaves_other_tensors_untouched():
    _need_cuda()
    buf = _x((3, 16, 32, 32), torch.bfloat16, device="cuda")
    before = buf.clone()
    x = buf[1]  # (16, 32, 32) as a (1, 16, 32, 32) view in the middle of the buffer
    x = x.unsqueeze(0)
    stats = _stats(16, device="cuda")
    kept = [t.clone() for t in stats]
    want = _plain(x, stats, True)
    got = ba.bn_act_eval(x, *stats, layers.BN_EPS, True)
    torch.cuda.synchronize()
    assert got.data_ptr() == x.data_ptr()
    assert torch.equal(buf[0], before[0]) and torch.equal(buf[2], before[2])
    assert all(torch.equal(a, b) for a, b in zip(stats, kept))
    assert _agreement(buf[1:2], want)[0] >= 0.999


def _tiny_cfg(name):
    from phiseg_tpu_torch.experiments import get_experiment

    return get_experiment(name).replace(latent_levels=3, resolution_levels=5, n0=4,
                                        image_size=(32, 32, 1), batch_size=4,
                                        compute_dtype="bfloat16")


def _bn_block_calls(model, fn):
    """fn() run with every BN'd conv block counted at each forward."""
    calls = []
    hooks = [m.register_forward_hook(lambda *_: calls.append(1)) for m in model.modules()
             if isinstance(m, layers._Normalised) and m.norm in ("batch", "batch_bf16")]
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
    return len(calls)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["phiseg_7_5_synth", "probunet_synth"])
def test_cuda_launches_one_per_bn_block_in_a_sampler_call_and_none_in_a_train_step(family):
    _need_cuda()
    from phiseg_tpu_torch.engine.train import create_train_state, make_sample_fn, make_train_step

    cfg = _tiny_cfg(family)
    state = create_train_state(cfg, device="cuda")
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(4, 32, 32, 1).astype(np.float32)).cuda()
    s = torch.from_numpy(rng.randint(0, 2, (4, 32, 32))).cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    sample = make_sample_fn(state.model, 5)
    sample(x, g)
    ba.reset_launch_counts()
    blocks = _bn_block_calls(state.model, lambda: sample(x, g))
    torch.cuda.synchronize()
    assert blocks > 0 and ba.LAUNCHES["bn_act_eval"] == blocks
    step = make_train_step(cfg)
    ba.reset_launch_counts()
    for _ in range(3):
        step(state, x, s, g)
    torch.cuda.synchronize()
    assert ba.LAUNCHES["bn_act_eval"] == 0
