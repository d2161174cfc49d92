"""Plain PyTorch reference of Stochastic Segmentation Networks (Monteiro et
al. 2020, arXiv:2006.06015) as biomedia-mira/stochastic_segmentation_networks
defines them (ssn/ssn.py, StochasticSegmentationNetwork; ssn/loss.py,
StochasticSegmentationNetworkLossMCIntegral) on PHiSeg-code's deterministic
U-Net: the configuration "ssn" names this module (`"reference": "ssn"`).

Functional, NCHW, float32 by default, TF32 off (`f32_mode`, which both
entry points call, as the harness does before them). Parameters
live in a flat dict by the program's state-dict names (`param_spec`), made
by the harness from its seed. Nothing here imports the program, nor the
repository's own reference of this model.

The network, for c = n0 * (1, 2, 4, 6, 6, ...) over R levels:
  block    a conv (3x3 unless stated; a bias only without batch norm),
           batch norm (eps 1e-3; the batch's statistics with the biased
           variance in training, the running ones in eval) and a relu;
  U-Net    3 blocks a level at c[l], a 2x2 average pool between levels;
           then for each finer level: bilinear x2 (half-pixel centres),
           concat with the encoder's feature there, 3 blocks at the
           coarser level's c; then three 1x1 blocks of n0 channels: h;
  heads    three 1x1 convs with bias on relu(h): mean (C), log_cov_diag
           (C), cov_factor (C R; channel r C + c is W's column r at class c).
The logits of an image, class-major over (C, H, W) (N = C H W), are a draw
of N(mu, W W^T + diag(D)), D = (exp(l) + 1e-5) * mask + 1e-5 with the mask
all ones: eta = mu + W eps_W + sqrt(D) eps_D, written as a plain matmul and
adds (so that the FLOP count on meta tensors sees the draw). The loss draws
M/2 = 10 of them, a = eta - mu, takes eta_m = mu + a_m and eta_{m+10} = mu -
a_m, log p_m(b) = -sum over pixels of CE(eta_m, y_b), and is -mean_b
(logsumexp_m log p_m(b) - log 20).

Departures from the source: the backbone is PHiSeg-code's U-Net, on which
the paper's LIDC experiment ran (recalled, not read); the mask is all ones
(a LIDC crop has no pixel outside the region of interest); the source's
fallback to a diagonal Normal where the capacitance's Cholesky fails is left
out: nothing here builds the capacitance; recalled from the code and not
read again: the double epsilon, the rank-major factor, the relu on the
backbone's output and the antithetic pairing. Weights are normal draws
(`init_std`): He normal kernels, the three heads' at HEAD_SCALE of it.

`prec` rounds every convolution of the backbone and the heads: "f32", "bf16"
(inputs, weights, outputs and each block's result rounded to bfloat16, as
the program's bf16 blocks cast them) or "fp8" (inputs and weights in float8
e4m3 with a per-tensor scale: the control). Batch norm, the heads' outputs
after the convolution, the draws, softmax and the loss are float32 in every
mode.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import AdamStep

BN_EPS = 1e-3
MC_SAMPLES = 20
EPS = 1e-5
HEADS = ("mean", "log_cov_diag", "cov_factor")

Params = Dict[str, torch.Tensor]
Draw = Callable[[Tuple[int, ...]], torch.Tensor]


def f32_mode() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def channels(n0: int, levels: int) -> List[int]:
    mults = [1, 2, 4] + [6] * max(0, levels - 3)
    return [n0 * m for m in mults[:levels]]


class Prec:
    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def out(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(torch.bfloat16).float() if self.mode == "bf16" else t

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.mode == "bf16":
            return t.to(torch.bfloat16).float()
        if self.mode == "fp8":
            scale = 448.0 / t.detach().abs().amax().clamp_min(1e-30)
            return (t * scale).to(torch.float8_e4m3fn).float() / scale
        return t


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _block(spec: list, name: str, cin: int, cout: int, k: int = 3, norm: bool = True,
           kind: str = "conv") -> None:
    spec.append((f"{name}.conv.weight", (cout, cin, k, k), kind))
    if norm:
        spec += [(f"{name}.bn.weight", (cout,), "one"), (f"{name}.bn.bias", (cout,), "zero"),
                 (f"{name}.bn.running_mean", (cout,), "zero"),
                 (f"{name}.bn.running_var", (cout,), "one")]
    else:
        spec.append((f"{name}.conv.bias", (cout,), "zero"))


def param_spec(cfg: Mapping) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every parameter and batch-norm statistic:
    kinds "conv" (He normal) and "head" (a head's kernel, He normal times
    HEAD_SCALE) drawn, "one" and "zero" constants."""
    if cfg["model_family"] != "ssn" or cfg["norm"] != "batch":
        raise NotImplementedError("this reference is SSN's, with batch norm")
    R, n0, C, rank = cfg["resolution_levels"], cfg["n0"], cfg["nlabels"], cfg["zdim0"]
    ch = channels(n0, R)
    spec: list = []
    cin = cfg["image_size"][2]
    for i, c in enumerate(ch):
        for k in range(3):
            _block(spec, f"likelihood.unet.encoder.level{i}_conv{k}", cin, c)
            cin = c
    for jj in range(R - 1):
        cin += ch[R - jj - 2]
        for k in range(3):
            _block(spec, f"likelihood.unet.dec{jj}_conv{k}", cin, ch[R - jj - 1])
            cin = ch[R - jj - 1]
    for k in range(3):
        _block(spec, f"likelihood.recomb{k}", cin, n0, k=1)
        cin = n0
    for head, cout in zip(HEADS, (C, C, C * rank)):
        _block(spec, f"likelihood.{head}", n0, cout, k=1, norm=False, kind="head")
    return spec


# The heads' kernels are drawn at He normal's scale times HEAD_SCALE. The
# untrained U-Net's features are small on the synthetic images (0.015-0.19
# rms, by the seed) and its bf16 round-off is ~2% of them, so the heads'
# scale sets both the draws' spread and the program's gap from the float32
# reference: at 1 the probabilities are not saturated, a dropped or misread
# factor W or diagonal D fails the check, and the float8 control parts from
# the program by 5x or more on every seed read (PERF.md lists the scales
# tried and their readings).
# control.py --head-scale reads the check at another.
HEAD_SCALE = 1.0


def init_std(shape: Sequence[int], kind: str) -> float:
    """He normal's sqrt(2 / fan_in) of an OIHW kernel, times HEAD_SCALE for
    a head's."""
    std = math.sqrt(2.0 / math.prod(shape[1:]))
    return std * HEAD_SCALE if kind == "head" else std


def trainable(spec) -> List[str]:
    """The names that training moves (not the running statistics)."""
    return [n for n, _, _ in spec if "running_" not in n]


def latent_shapes(cfg: Mapping, batch: int) -> List[Tuple[int, ...]]:
    """The sampler's two noises, channels last, as the program draws them:
    eps_D (B, H, W, C), one a logit, and eps_W (B, R)."""
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
    def __init__(self, cfg: Mapping, params: Params, training: bool, prec: str = "f32"):
        self.cfg, self.p, self.training, self.q = cfg, params, training, Prec(prec)
        self.ch = channels(cfg["n0"], cfg["resolution_levels"])

    def conv(self, name: str, x: torch.Tensor, k: int) -> torch.Tensor:
        q = self.q
        return q.out(F.conv2d(q(x), q(self.p[f"{name}.conv.weight"]),
                              self.p.get(f"{name}.conv.bias"), padding=k // 2))

    def block(self, name: str, x: torch.Tensor, k: int = 3) -> torch.Tensor:
        y = self.conv(name, x, k)
        if self.training:
            mean = y.mean(dim=(0, 2, 3), keepdim=True)
            var = (y - mean).square().mean(dim=(0, 2, 3), keepdim=True)
        else:
            mean = self.p[f"{name}.bn.running_mean"].view(1, -1, 1, 1)
            var = self.p[f"{name}.bn.running_var"].view(1, -1, 1, 1)
        w = self.p[f"{name}.bn.weight"].view(1, -1, 1, 1)
        b = self.p[f"{name}.bn.bias"].view(1, -1, 1, 1)
        return F.relu(self.q.out((y - mean) * torch.rsqrt(var + BN_EPS) * w + b))

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
        """(mu (B, N), W (B, N, R), D (B, N)) of x (B, Cin, H, W), float32."""
        h = self.features(x)
        b, rank = h.shape[0], self.cfg["zdim0"]
        mu, log_d, factor = (self.conv(f"likelihood.{head}", h, 1).float() for head in HEADS)
        diag = torch.exp(log_d).reshape(b, -1) + EPS
        diag = diag * torch.ones_like(diag) + EPS
        return mu.reshape(b, -1), factor.reshape(b, rank, -1).transpose(1, 2), diag


def nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def draw_logits(mu, factor, diag, eps_d: torch.Tensor, eps_w: torch.Tensor) -> torch.Tensor:
    """eta (S, B, N) of eps_d (S, B, H, W, C), channels last, and eps_w (S, B, R)."""
    s, b = eps_w.shape[:2]
    noise_d = nchw(eps_d.float().reshape(s * b, *eps_d.shape[2:])).reshape(s, b, -1)
    low_rank = torch.matmul(factor, eps_w.float().unsqueeze(-1)).squeeze(-1)
    return mu + low_rank + diag.sqrt() * noise_d


# ---------------------------------------------------------------------------
# Training: the Monte Carlo loss
# ---------------------------------------------------------------------------


def grad_step(cfg: Mapping, params: Params, x: torch.Tensor, s: torch.Tensor, draw: Draw,
              prec: str = "f32", generator: Optional[torch.Generator] = None, state=None):
    """One training forward and backward of the augmented batch x (B,H,W,C),
    s (B,H,W): (loss, gradients by name, state). eps_D (M/2, B, H, W, C)
    then eps_W (M/2, B, R) come from draw(shape), the program's order; no
    other draw, and no train state."""
    f32_mode()
    names = trainable(param_spec(cfg))
    leaves = {n: params[n].detach().requires_grad_(True) for n in names}
    eps_d, eps_w = (draw((MC_SAMPLES // 2, *shape)) for shape in latent_shapes(cfg, x.shape[0]))
    with torch.enable_grad():
        mu, factor, diag = Net(cfg, dict(params, **leaves), True, prec).distribution(
            nchw(x).float())
        b, c = mu.shape[0], cfg["nlabels"]
        samples = draw_logits(mu, factor, diag, eps_d, eps_w) - mu
        logits = torch.cat([samples, -samples]) + mu                  # (M, B, N)
        target = s.long().reshape(1, b, -1).expand(MC_SAMPLES, b, -1).reshape(MC_SAMPLES * b, -1)
        log_prob = -F.cross_entropy(logits.reshape(MC_SAMPLES * b, c, -1), target,
                                    reduction="none").reshape(MC_SAMPLES, b, -1)
        loglik = torch.logsumexp(log_prob.sum(-1), dim=0) - math.log(MC_SAMPLES)
        loss = -loglik.mean()
        grads = torch.autograd.grad(loss, [leaves[n] for n in names], allow_unused=True)
    return loss.detach(), {n: (torch.zeros_like(leaves[n]) if g is None else g)
                           for n, g in zip(names, grads)}, state


def train_state(cfg: Mapping, params: Params) -> None:
    """SSN carries no train state from step to step."""
    return None


def lr_at(cfg: Mapping, step: int) -> float:
    """The learning-rate schedule: the value of the largest threshold <= step."""
    sched = sorted((int(k), float(v)) for k, v in cfg["lr_schedule"].items())
    lr = sched[0][1]
    for k, v in sched:
        if k <= step:
            lr = v
    return lr


def optimizer(cfg: Mapping, params: Params, names: Sequence[str]) -> AdamStep:
    """Adam alone, at lr_at."""
    return AdamStep(lambda step: lr_at(cfg, step), params, names)


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


@torch.no_grad()
def sample_probs(cfg: Mapping, params: Params, x: torch.Tensor, eps: Sequence[torch.Tensor],
                 prec: str = "f32") -> torch.Tensor:
    """Softmax probabilities (S, B, H, W, C) of S draws an image in eval batch
    norm: the network once on x (B, H, W, C), then eps = (eps_D (S, B, H, W,
    C), eps_W (S, B, R)), latent_shapes with a leading S."""
    f32_mode()
    mu, factor, diag = Net(cfg, params, False, prec).distribution(nchw(x).float())
    eta = draw_logits(mu, factor, diag, *eps)
    s, b = eta.shape[:2]
    h, w = cfg["image_size"][:2]
    probs = torch.softmax(eta.reshape(s, b, cfg["nlabels"], h, w), dim=2)
    return probs.permute(0, 1, 3, 4, 2)
