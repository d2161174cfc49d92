"""bn_fused_pct, the share of eval-mode BN launches that ran as the fused
bn_act_eval kernel, on trace summaries made by hand: 0 where only cuDNN's
or PyTorch's BN kernels ran (a program without the kernel), 100 where only
the kernel ran, the share of launches where both did, None where neither
did (a train step, a family without BN) and untraced."""

import types

import pytest

from portbench.cells import Bench
from portbench.tests.tiny import ROOT

CUDNN = ("void cudnn::bn_fw_inf_1C11_kernel_NCHW<float, float, true, 1>(float, float, "
         "cudnnTensorStruct, float const*, cudnnTensorStruct, float*, cudnnTensorStruct, "
         "float const*, float const*, float const*, float const*, float)")
NATIVE = ("void at::native::batch_norm_transform_input_kernel<float, float, float, true, int>"
          "(...)")
OURS = ("void (anonymous namespace)::bn_act_eval_kernel<__nv_bfloat16, 8, true>"
        "((anonymous namespace)::Layout, ...)")
OTHER = [("void cudnn::ops::nchwToNhwcKernel<__nv_bfloat16>(...)", 900.0, 60),
         ("void at::native::vectorized_elementwise_kernel<4, at::native::clamp_min...>", 500.0, 45)]


def _ctx(ops):
    return types.SimpleNamespace(trace=None if ops is None else {"ops": OTHER + ops})


@pytest.mark.parametrize("metric", ["bn_fused_pct.eval", "bn_fused_pct.sample",
                                    "bn_fused_pct.probunet_eval"])
@pytest.mark.parametrize("ops,want", [
    ([(CUDNN, 4768.0, 45)], 0.0),                               # the parent: cuDNN's eval BN
    ([(CUDNN, 100.0, 30), (NATIVE, 10.0, 10)], 0.0),            # cuDNN's and PyTorch's
    ([(OURS, 1200.0, 45)], 100.0),                              # every BN'd block fused
    ([(OURS, 300.0, 30), (CUDNN, 90.0, 9), (NATIVE, 10.0, 1)], 75.0),  # launches, not time
    ([], None),                                                 # no eval BN: train, HPU-Net
    (None, None),                                               # untraced
])
def test_the_share_of_fused_launches(metric, ops, want):
    assert Bench(ROOT).reader(metric)(_ctx(ops)) == want
