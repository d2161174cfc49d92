"""The port's training diagnostics and image grids vs phiseg_tpu's on the CPU.

Histograms: the same tensor through both. Bucket edges agree to f32
round-off of the range (1e-6 of it); a value within that of an edge may fall
in the neighbouring bucket (all 40 values of a constant tensor lie on an
edge), so the counts below an edge may differ by the values near it; the
totals agree.
The diagnostics forward gets JAX's posterior noise with each key (eps =
(z - mu) / sigma of its eval forward), in f32: scalars rtol 1e-4, label maps
equal except at near-ties of the logits (|l1 - l0| < 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phiseg_tpu.engine.config import ExperimentConfig as JaxConfig
from phiseg_tpu.engine.train import build_model as jax_build_model
from phiseg_tpu.utils import diagnostics as jd
from phiseg_tpu.utils import image_grid as jgrid
from phiseg_tpu_torch.convert import flax_to_state_dict
from phiseg_tpu_torch.engine.config import ExperimentConfig
from phiseg_tpu_torch.engine.train import build_model
from phiseg_tpu_torch.utils import diagnostics as td
from phiseg_tpu_torch.utils import image_grid as tgrid

torch.set_num_threads(1)
CFG = dict(model_family="phiseg", latent_levels=2, resolution_levels=4, n0=2, zdim0=2,
           image_size=(16, 16, 1), compute_dtype="float32", norm="batch")


def _hist_close(got, want, what, values=None):
    """Stats and edges to f32 round-off of the range; the counts below each
    inner edge may differ only by the values that lie within that round-off
    of the edge (by at most 1 where the values are not given)."""
    want = jax.device_get(want)
    got = {k: np.asarray(v) for k, v in got.items()}
    span = float(want["max"] - want["min"]) or 1.0
    for k in ("min", "max", "num", "sum", "sum_squares"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6 * span, err_msg=what)
    np.testing.assert_allclose(got["bucket_limits"], want["bucket_limits"], rtol=1e-5,
                               atol=1e-6 * span, err_msg=what)
    below = np.abs(np.cumsum(got["bucket_counts"]) - np.cumsum(want["bucket_counts"]))[:-1]
    if values is None:
        near = np.ones_like(below)
    else:
        edges = want["bucket_limits"][:-1]
        near = (np.abs(values.ravel()[None, :] - edges[:, None]) <= 1e-6 * span).sum(1)
    assert (below <= near).all(), what
    assert got["bucket_counts"].sum() == want["bucket_counts"].sum() == want["num"], what


@pytest.mark.parametrize("case", ["normal", "constant", "wide", "bf16"])
def test_tensor_histogram_matches_jax(case):
    rng = np.random.RandomState(0)
    v = {"normal": rng.randn(257), "constant": np.zeros(40), "wide": 80 * rng.randn(1000),
         "bf16": rng.randn(300)}[case].astype(np.float32)
    t = torch.from_numpy(v)
    if case == "bf16":
        t = t.bfloat16()
        v = t.float().numpy()
    got = td.tensor_histogram(t, bins=20)
    assert got["bucket_counts"].shape == (20,)
    _hist_close(got, jd.tensor_histogram(jnp.asarray(v), bins=20), case, v)


@pytest.fixture(scope="module")
def models():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 16, 16, 1).astype(np.float32)
    s = (rng.rand(2, 16, 16) > 0.6).astype(np.int32)
    jcfg = JaxConfig(**CFG)
    jmod = jax_build_model(jcfg)
    s_oh = jax.nn.one_hot(jnp.asarray(s), 2)
    shapes = jax.eval_shape(lambda k: jmod.init({"params": k}, jnp.asarray(x), s_oh, k,
                                                train=True), jax.random.PRNGKey(0))

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            return (rng.randn(*leaf.shape) * np.sqrt(2.0 / np.prod(leaf.shape[:-1]))).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)  # scale, var

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    tcfg = ExperimentConfig(**CFG)
    tmod = build_model(tcfg, device="cpu")
    tmod.load_state_dict(flax_to_state_dict(variables, tmod))
    return dict(x=x, s=s, jcfg=jcfg, jmod=jmod, variables=variables, tcfg=tcfg, tmod=tmod)


def test_diag_fn_matches_jax(models):
    m = models
    key = jax.random.PRNGKey(2)
    w_scalars, w_grids, w_hists = jax.device_get(jd.make_diag_fn(m["jmod"], m["jcfg"])(
        m["variables"], jnp.asarray(m["x"]), jnp.asarray(m["s"]), key))
    out = m["jmod"].apply(m["variables"], jnp.asarray(m["x"]),
                          jax.nn.one_hot(jnp.asarray(m["s"]), 2), key, train=False)
    eps = [torch.from_numpy((np.asarray(z) - np.asarray(mu)) / np.asarray(sg))
           for z, mu, sg in zip(out.z, out.q_mu, out.q_sigma)]
    tmod = m["tmod"]
    tmod.train()  # the diagnostics forward runs in eval mode and switches back
    scalars, grids, hists = td.make_diag_fn(tmod, m["tcfg"])(
        torch.from_numpy(m["x"]), torch.from_numpy(m["s"]), eps=eps)
    assert tmod.training
    tmod.eval()
    assert sorted(scalars) == sorted(w_scalars)
    for k, v in scalars.items():
        np.testing.assert_allclose(v, w_scalars[k], rtol=1e-4, atol=1e-5, err_msg=k)
    assert sorted(grids) == sorted(w_grids)
    # the accumulated logits, to tell near-ties
    acc = np.asarray(out.s_out_list[-1])
    accs = {len(out.s_out_list) - 1: acc}
    for i in range(len(out.s_out_list) - 2, -1, -1):
        acc = acc + np.asarray(out.s_out_list[i])
        accs[i] = acc
    for k, g in grids.items():
        assert g.dtype == np.int32 and g.shape == (2, 16, 16), k
        if k.startswith("s_out_list_"):
            logits = np.asarray(out.s_out_list[int(k.rsplit("_", 1)[1])])
        else:
            logits = accs[0 if k == "s_out" else int(k.rsplit("_", 1)[1])]
        diff = g != w_grids[k]
        assert (np.abs(logits[..., 1] - logits[..., 0])[diff] < 1e-4).all(), k
    np.testing.assert_array_equal(grids["s_accum_list_0"], grids["s_out"])
    # activation histograms: one per module with a tensor output
    assert len(hists) > 10 and len(w_hists) > 10
    for name, h in hists.items():
        assert name.startswith("activations/")
        assert h["bucket_counts"].shape == (30,) and h["bucket_counts"].sum() == h["num"]
        assert np.isfinite(h["sum"])
    # the likelihood's level-0 output block is the same tensor on both sides
    _hist_close(hists["activations/likelihood.out0"],
                w_hists["activations/likelihood/out0/__call__/0"], "out0")

    _, _, none = td.make_diag_fn(tmod, m["tcfg"], histograms=False)(
        torch.from_numpy(m["x"]), torch.from_numpy(m["s"]), eps=eps)
    assert none == {}


def test_param_hists_match_jax_tensor_by_tensor(models):
    """Each parameter's histogram equals JAX's of the same values (a layout
    change from HWIO to OIHW permutes a kernel, which a histogram does not
    see); one histogram per floating parameter of 2 elements or more, as
    many as the flax tree has."""
    m = models
    hists = td.make_param_hist_fn()(m["tmod"])
    want = jax.device_get(jd.make_param_hist_fn()(m["variables"]["params"]))
    assert len(hists) == len(want)
    assert all(k.startswith("weights/") for k in hists)
    for name, p in m["tmod"].named_parameters():
        v = p.detach().numpy()
        _hist_close(hists[f"weights/{name}"], jd.tensor_histogram(jnp.asarray(v)), name, v)


def test_first_conv_kernel_is_hwio_and_gridded_as_in_jax(models):
    tmod = models["tmod"]
    name, kernel = td.first_conv_kernel(tmod)
    weight = dict(tmod.named_parameters())[name]
    assert weight.ndim == 4 and weight.shape[2] > 1
    np.testing.assert_array_equal(kernel, weight.detach().permute(2, 3, 1, 0).numpy())
    grid = tgrid.kernels_to_grid(kernel)
    np.testing.assert_array_equal(grid, jgrid.kernels_to_grid(kernel))
    labels = np.random.RandomState(3).randint(0, 2, (5, 8, 8))
    np.testing.assert_array_equal(tgrid.batch_to_grid(labels, "labelmap", 2),
                                  jgrid.batch_to_grid(labels, "labelmap", 2))
