"""The repository's plain PyTorch reference of Stochastic Segmentation
Networks (Monteiro et al. 2020, "Stochastic Segmentation Networks: Modelling
Spatially Correlated Aleatoric Uncertainty", arXiv:2006.06015), as
biomedia-mira/stochastic_segmentation_networks defines them (ssn/ssn.py,
StochasticSegmentationNetwork; ssn/loss.py,
StochasticSegmentationNetworkLossMCIntegral) on PHiSeg-code's deterministic
U-Net (phiseg/models/likelihoods.py `det_unet2D` without its last 1x1
conv): the forward, the sampler under given noise, the Monte Carlo loss and
its gradients. The tests (tests/test_torch_ssn.py) hold the port's family
"ssn" to it on the CPU.

Functional, NCHW, float32, TF32 off (`f32_mode`, which every entry point
calls). Parameters live in a flat dict by the port's state-dict names
(`param_spec`). Nothing here imports phiseg_tpu or phiseg_tpu_torch, nor the
benchmark's copy of this model.

The network, for c = n0 * (1, 2, 4, 6, 6, ...) over R levels:
  block    a conv (3x3 unless stated; a bias only without batch norm),
           batch norm (eps 1e-3; the batch's statistics with the biased
           variance in training, the running ones in eval) and a relu;
  U-Net    3 blocks a level at c[l], a 2x2 average pool between levels;
           then for each finer level: bilinear x2 (half-pixel centres),
           concat with the encoder's feature there, 3 blocks at the
           coarser level's c;
  recomb   three 1x1 blocks of n0 channels: the features h (ReLU'd, so
           the source's relu on the backbone's output changes nothing);
  heads    three 1x1 convs with bias on h: mean (C), log_cov_diag (C),
           cov_factor (C R, channel r C + c is W's column r at class c).
The logits of an image, class-major over (C, H, W) (N = C H W), are drawn
from N(mu, W W^T + diag(D)) with D = exp(l) + 1e-5, times a mask of ones,
plus 1e-5: eta = mu + W eps_W + sqrt(D) eps_D. The loss draws M/2 = 10 of
them, a = eta - mu, and takes eta_m = mu + a_m and eta_{m+10} = mu - a_m;
log p_m(b) = -sum over pixels of CE(eta_m, y_b); loss = -mean_b
(logsumexp_m log p_m(b) - log 20).

Departures from the source: the backbone is PHiSeg-code's U-Net, on which
the paper's LIDC experiment was run (recalled, not read); the mask is all
ones (a LIDC crop has no region outside the region of interest); the
source's fallback to a diagonal Normal where the capacitance's Cholesky
fails is left out, since the draw needs no capacitance; recalled from the
code and not read again: the double epsilon, the rank-major factor layout,
the relu on the backbone's output and the antithetic pairing. The weights
are the caller's.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
MC_SAMPLES = 20
EPS = 1e-5

Params = Dict[str, torch.Tensor]
Draw = Callable[[Tuple[int, ...]], torch.Tensor]


def channels(n0: int, levels: int) -> List[int]:
    mults = [1, 2, 4] + [6] * max(0, levels - 3)
    return [n0 * m for m in mults[:levels]]


def f32_mode() -> None:
    """Float32 convolutions and matmuls: TF32 off in cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _block_spec(spec: list, name: str, cin: int, cout: int, k: int = 3, norm: bool = True):
    spec.append((f"{name}.conv.weight", (cout, cin, k, k)))
    if norm:
        spec += [(f"{name}.bn.weight", (cout,)), (f"{name}.bn.bias", (cout,)),
                 (f"{name}.bn.running_mean", (cout,)), (f"{name}.bn.running_var", (cout,))]
    else:
        spec.append((f"{name}.conv.bias", (cout,)))


def param_spec(cfg: Mapping) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter and batch-norm statistic."""
    if cfg["model_family"] != "ssn" or cfg["norm"] != "batch":
        raise NotImplementedError("this reference is SSN's, with batch norm")
    R, n0, C, rank = cfg["resolution_levels"], cfg["n0"], cfg["nlabels"], cfg["zdim0"]
    ch = channels(n0, R)
    spec: list = []
    cin = cfg["image_size"][2]
    for i, c in enumerate(ch):
        for k in range(3):
            _block_spec(spec, f"likelihood.unet.encoder.level{i}_conv{k}", cin, c)
            cin = c
    for jj in range(R - 1):
        cin += ch[R - jj - 2]
        for k in range(3):
            _block_spec(spec, f"likelihood.unet.dec{jj}_conv{k}", cin, ch[R - jj - 1])
            cin = ch[R - jj - 1]
    for k in range(3):
        _block_spec(spec, f"likelihood.recomb{k}", cin, n0, k=1)
        cin = n0
    for head, cout in (("mean", C), ("log_cov_diag", C), ("cov_factor", C * rank)):
        _block_spec(spec, f"likelihood.{head}", n0, cout, k=1, norm=False)
    return spec


def trainable(spec) -> List[str]:
    """The names that training moves (not the running statistics)."""
    return [n for n, *_ in spec if "running_" not in n]


def latent_shapes(cfg: Mapping, batch: int) -> List[Tuple[int, ...]]:
    """The sampler's two noises, channels last: eps_D (B, H, W, C), eps_W (B, R)."""
    h, w = cfg["image_size"][:2]
    return [(batch, h, w, cfg["nlabels"]), (batch, cfg["zdim0"])]


# ---------------------------------------------------------------------------
# The network
# ---------------------------------------------------------------------------


def _pool2(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape[-2:]
    if h % 2 or w % 2:
        x = F.pad(x, (0, w % 2, 0, h % 2))
    return F.avg_pool2d(x, 2, 2)


def _up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


class Net:
    def __init__(self, cfg: Mapping, params: Params, training: bool):
        self.cfg, self.p, self.training = cfg, params, training
        self.ch = channels(cfg["n0"], cfg["resolution_levels"])

    def block(self, name: str, x: torch.Tensor, k: int = 3) -> torch.Tensor:
        y = F.conv2d(x, self.p[f"{name}.conv.weight"], padding=k // 2)
        if self.training:
            mean = y.mean(dim=(0, 2, 3), keepdim=True)
            var = (y - mean).square().mean(dim=(0, 2, 3), keepdim=True)
        else:
            mean = self.p[f"{name}.bn.running_mean"].view(1, -1, 1, 1)
            var = self.p[f"{name}.bn.running_var"].view(1, -1, 1, 1)
        y = (y - mean) * torch.rsqrt(var + BN_EPS) * self.p[f"{name}.bn.weight"].view(1, -1, 1, 1) \
            + self.p[f"{name}.bn.bias"].view(1, -1, 1, 1)
        return F.relu(y)

    def head(self, name: str, h: torch.Tensor) -> torch.Tensor:
        return F.conv2d(h, self.p[f"{name}.conv.weight"], self.p[f"{name}.conv.bias"])

    def features(self, x: torch.Tensor) -> torch.Tensor:
        R = len(self.ch)
        enc = []
        for i in range(R):
            if i > 0:
                x = _pool2(x)
            for k in range(3):
                x = self.block(f"likelihood.unet.encoder.level{i}_conv{k}", x)
            enc.append(x)
        net = enc[-1]
        for jj in range(R - 1):
            net = torch.cat([_up2(net), enc[R - jj - 2]], dim=1)
            for k in range(3):
                net = self.block(f"likelihood.unet.dec{jj}_conv{k}", net)
        for k in range(3):
            net = self.block(f"likelihood.recomb{k}", net, k=1)
        return F.relu(net)

    def distribution(self, x: torch.Tensor):
        """(mu (B, N), W (B, N, R), D (B, N)) of x (B, Cin, H, W)."""
        h = self.features(x)
        b, rank = h.shape[0], self.cfg["zdim0"]
        mu = self.head("likelihood.mean", h).reshape(b, -1)
        diag = torch.exp(self.head("likelihood.log_cov_diag", h)).reshape(b, -1) + EPS
        diag = diag * torch.ones_like(diag) + EPS  # the mask: every pixel inside
        factor = self.head("likelihood.cov_factor", h).reshape(b, rank, -1).transpose(1, 2)
        return mu, factor, diag


def nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def distribution(cfg: Mapping, params: Params, x: torch.Tensor, training: bool = False):
    """(mu, W, D) of x (B, H, W, Cin), class-major, in the parameters' dtype
    (float32; float64 for a check of round-off)."""
    f32_mode()
    dtype = params["likelihood.mean.conv.weight"].dtype
    return Net(cfg, params, training).distribution(nchw(x).to(dtype))


def draw_logits(mu: torch.Tensor, factor: torch.Tensor, diag: torch.Tensor,
                eps_d: torch.Tensor, eps_w: torch.Tensor) -> torch.Tensor:
    """eta (S, B, N) = mu + W eps_W + sqrt(D) eps_D of noises eps_d (S, B,
    H, W, C), channels last, and eps_w (S, B, R)."""
    s, b = eps_w.shape[:2]
    noise_d = nchw(eps_d.to(mu.dtype).reshape(s * b, *eps_d.shape[2:])).reshape(s, b, -1)
    low_rank = torch.matmul(factor, eps_w.to(mu.dtype).unsqueeze(-1)).squeeze(-1)
    return mu + low_rank + diag.sqrt() * noise_d


@torch.no_grad()
def sample_probs(cfg: Mapping, params: Params, x: torch.Tensor,
                 eps: Sequence[torch.Tensor]) -> torch.Tensor:
    """Softmax probabilities (S, B, H, W, C) of S draws an image, in eval
    batch norm: eps = (eps_D (S, B, H, W, C), eps_W (S, B, R))."""
    mu, factor, diag = distribution(cfg, params, x)
    eta = draw_logits(mu, factor, diag, *eps)
    s, b = eta.shape[:2]
    h, w = cfg["image_size"][:2]
    probs = torch.softmax(eta.reshape(s, b, cfg["nlabels"], h, w), dim=2)
    return probs.permute(0, 1, 3, 4, 2)


# ---------------------------------------------------------------------------
# Training: the Monte Carlo loss
# ---------------------------------------------------------------------------


def loss(cfg: Mapping, params: Params, x: torch.Tensor, s: torch.Tensor, eps_d: torch.Tensor,
         eps_w: torch.Tensor, training: bool = True):
    """(loss, summaries) of x (B, H, W, Cin) and labels s (B, H, W) under the
    M/2 noises eps_d (M/2, B, H, W, C), eps_w (M/2, B, R)."""
    mu, factor, diag = distribution(cfg, params, x, training)
    half = eps_w.shape[0]
    m, b, c = 2 * half, mu.shape[0], cfg["nlabels"]
    samples = draw_logits(mu, factor, diag, eps_d, eps_w) - mu
    logits = torch.cat([samples, -samples]) + mu                     # (M, B, N)
    target = s.long().reshape(1, b, -1).expand(m, b, -1).reshape(m * b, -1)
    log_prob = -F.cross_entropy(logits.reshape(m * b, c, -1), target,
                                reduction="none").reshape(m, b, -1)
    log_p = log_prob.sum(dim=-1)
    loglik = torch.logsumexp(log_p, dim=0) - math.log(m)
    total = -loglik.mean()
    return total, {"ssn_loglik": loglik.mean(), "ssn_ce_mean": -log_p.mean(),
                   "ssn_cov_diag_mean": diag.mean(),
                   "ssn_cov_factor_rms": factor.square().mean().sqrt(), "total_loss": total}


def grad_step(cfg: Mapping, params: Params, x: torch.Tensor, s: torch.Tensor, draw: Draw):
    """(summaries, gradients by name): one training forward in batch-norm
    training mode, eps_D then eps_W from draw(shape) with a leading M/2."""
    names = trainable(param_spec(cfg))
    leaves = {n: params[n].detach().requires_grad_(True) for n in names}
    shapes = latent_shapes(cfg, x.shape[0])
    eps_d, eps_w = (draw((MC_SAMPLES // 2, *shape)) for shape in shapes)
    with torch.enable_grad():
        total, summaries = loss(cfg, dict(params, **leaves), x, s, eps_d, eps_w)
        grads = torch.autograd.grad(total, [leaves[n] for n in names], allow_unused=True)
    out = {n: (torch.zeros_like(leaves[n]) if g is None else g) for n, g in zip(names, grads)}
    return {k: v.detach() for k, v in summaries.items()}, out
