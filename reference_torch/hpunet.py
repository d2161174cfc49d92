"""The repository's plain PyTorch reference of the Hierarchical Probabilistic
U-Net (Kohl et al. 2019, "A Hierarchical Probabilistic U-Net for Modeling
Multi-Scale Segmentation Ambiguities", arXiv:1905.13077), as
deepmind-research's hierarchical_probabilistic_unet/model.py (class
HierarchicalProbUNet with its default arguments) and geco_utils.py define
it: the forward, the prior sampler, the GECO loss, its gradients and Adam.
The tests (tests/test_torch_hpunet.py) hold the port's family "hpu_net" to
it on the CPU.

Functional, NCHW, float32, TF32 off (`f32_mode`, which every entry point
calls). Parameters live in a flat dict by the port's state-dict names
(`param_spec`). Nothing here imports phiseg_tpu or phiseg_tpu_torch, nor the
benchmark's copy of this model.

The network, for c = n0 * (1, 2, 4, 8, 8, ...) over R levels and d = c / 2:
  res(h) = skip(h) + proj(conv2(relu(conv1(relu(conv0(relu(h))))))), the
           3x3 convs to d channels, proj a 1x1 conv to n, skip a 1x1 conv
           where h has not n channels, else h; every conv has a bias;
  core     3 blocks a level at c[l], a 2x2 average pool between levels;
           then from the coarsest feature f, for i = 0 .. L-1: a 1x1 conv
           to (mu, log sigma), z_i = mu + exp(log sigma) eps_i (or the
           posterior's z_i), f = blocks(concat(up2(concat(z_i, f)), e)),
           3 blocks at c[R-2-i] on the encoder's feature e of that scale;
  stitch   for levels L+1 .. R-1: f = blocks(concat(up2(f), e)) at the
           level's c, on the prior's encoder; a 1x1 conv to the logits.
up2 is nearest x2. Training: the posterior core on concat(x, one-hot s),
the prior core on x with the posterior's z; KL(q || p) analytic a level,
summed over pixels, batch mean, summed over levels; the CE of the top
floor(0.02 B H W) pixels by log(xe / sum xe) + Gumbel noise, summed an
image, batch mean; GECO: a zero-debiased moving average (decay 0.99) of it
with its gradient, less 0.05 x the selected pixels an image, times a
multiplier that starts at 1, steps by its gradient scaled by -0.01 and is
kept >= 0, plus the KL.

Departures from the source: the posterior's input is concat(x, s) where
the source has concat(s, x) (a permutation of the first conv's input
channels); the l2(1e-5) regularisers on kernels and biases are left out;
recalled from the code and not read: the block's conv count and activation
placement, and the multiplier's clamp at 0. The weights are the caller's.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


TOP_K_SHARE = 0.02
KAPPA = 0.05
DECAY = 0.99
RATE = 1e-2
BLOCKS = 3
CONVS = 3
BIAS_STD = 0.001
GECO_STATE = ("geco.ma_hidden", "geco.ma_count")

Params = Dict[str, torch.Tensor]
Draw = Callable[[Tuple[int, ...]], torch.Tensor]


def channels(n0: int, levels: int) -> List[int]:
    mults = [1, 2, 4] + [8] * max(0, levels - 3)
    return [n0 * m for m in mults[:levels]]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _conv_spec(spec: list, name: str, cin: int, cout: int, k: int) -> None:
    spec.append((f"{name}.conv.weight", (cout, cin, k, k), "conv"))
    spec.append((f"{name}.conv.bias", (cout,), "bias"))


def _res_spec(spec: list, name: str, cin: int, n: int) -> None:
    c = cin
    for k in range(CONVS):
        _conv_spec(spec, f"{name}.conv{k}", c, n // 2, 3)
        c = n // 2
    _conv_spec(spec, f"{name}.proj", n // 2, n, 1)
    if cin != n:
        _conv_spec(spec, f"{name}.skip", cin, n, 1)


def _level_spec(spec: list, prefix: str, cin: int, n: int) -> None:
    for b in range(BLOCKS):
        _res_spec(spec, f"{prefix}_block{b}", cin if b == 0 else n, n)


def _core_spec(spec: list, prefix: str, cin: int, ch: Sequence[int], L: int, zdim: int) -> None:
    R = len(ch)
    for lvl in range(R):
        _level_spec(spec, f"{prefix}.enc{lvl}", cin, ch[lvl])
        cin = ch[lvl]
    f = ch[R - 1]
    for i in range(L):
        _conv_spec(spec, f"{prefix}.dec{i}_head", f, 2 * zdim, 1)
        _level_spec(spec, f"{prefix}.dec{i}", zdim + f + ch[R - 2 - i], ch[R - 2 - i])
        f = ch[R - 2 - i]


def param_spec(cfg: Mapping) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every parameter and buffer by the port's
    state-dict names: kinds "conv" (a kernel) and "bias", the multiplier
    "one", the moving average's hidden value and count "zero"."""
    if cfg["model_family"] != "hpu_net" or cfg["norm"] != "none":
        raise NotImplementedError("this reference is the HPU-Net's, without normalisation")
    R, L, n0, zdim = cfg["resolution_levels"], cfg["latent_levels"], cfg["n0"], cfg["zdim0"]
    cin, nl = cfg["image_size"][2], cfg["nlabels"]
    ch = channels(n0, R)
    spec: list = []
    _core_spec(spec, "posterior", cin + nl, ch, L, zdim)
    _core_spec(spec, "prior", cin, ch, L, zdim)
    f = ch[R - 1 - L]
    for lvl in range(L + 1, R):
        c = ch[R - 1 - lvl]
        _level_spec(spec, f"likelihood.level{lvl}", f + c, c)
        f = c
    _conv_spec(spec, "likelihood.logits", ch[0], nl, 1)
    spec += [("geco.lagmul", (), "one"), ("geco.ma_hidden", (), "zero"),
             ("geco.ma_count", (), "zero")]
    return spec


def trainable(spec) -> List[str]:
    """Every parameter and the multiplier; not the moving average's state."""
    return [n for n, _, _ in spec if n not in GECO_STATE]


def latent_shapes(cfg: Mapping, batch: int) -> List[Tuple[int, ...]]:
    """(B, h, w, zdim) a latent level, finest first: the image halved
    R - L + i times."""
    R, L = cfg["resolution_levels"], cfg["latent_levels"]
    h, w = cfg["image_size"][:2]
    return [(batch, h >> (R - L + i), w >> (R - L + i), cfg["zdim0"]) for i in range(L)]


# ---------------------------------------------------------------------------
# The network
# ---------------------------------------------------------------------------


def _up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Net:
    def __init__(self, cfg: Mapping, params: Params):
        self.p = params
        self.R, self.L, self.zdim = cfg["resolution_levels"], cfg["latent_levels"], cfg["zdim0"]

    def conv(self, name: str, x: torch.Tensor, k: int) -> torch.Tensor:
        return F.conv2d(x, self.p[f"{name}.conv.weight"], self.p[f"{name}.conv.bias"],
                        padding=k // 2)

    def res(self, name: str, h: torch.Tensor) -> torch.Tensor:
        r = F.relu(h)
        for k in range(CONVS):
            r = self.conv(f"{name}.conv{k}", r, 3)
            if k < CONVS - 1:
                r = F.relu(r)
        r = self.conv(f"{name}.proj", r, 1)
        skip = self.conv(f"{name}.skip", h, 1) if f"{name}.skip.conv.weight" in self.p else h
        return skip + r

    def level(self, prefix: str, h: torch.Tensor) -> torch.Tensor:
        for b in range(BLOCKS):
            h = self.res(f"{prefix}_block{b}", h)
        return h

    def encode(self, prefix: str, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        h = x
        for lvl in range(self.R):
            if lvl > 0:
                h = F.avg_pool2d(h, 2, 2)
            h = self.level(f"{prefix}.enc{lvl}", h)
            feats.append(h)
        return feats

    def decode(self, prefix: str, enc: Sequence[torch.Tensor], noise=None, z_in=None):
        """(features, z, mu, log sigma), the lists coarsest first. noise(i,
        mu) gives level i's eps; z_in (coarsest first) replaces the draws."""
        R, zd = self.R, self.zdim
        f = enc[R - 1]
        zs, mus, logs = [], [], []
        for i in range(self.L):
            ms = self.conv(f"{prefix}.dec{i}_head", f, 1)
            mu, log_sigma = ms[:, :zd], ms[:, zd:]
            z = z_in[i] if z_in is not None else mu + torch.exp(log_sigma) * noise(i, mu)
            zs.append(z)
            mus.append(mu)
            logs.append(log_sigma)
            f = _up2(torch.cat([z, f], dim=1))
            f = self.level(f"{prefix}.dec{i}", torch.cat([f, enc[R - 2 - i]], dim=1))
        return f, zs, mus, logs

    def stitch(self, enc: Sequence[torch.Tensor], f: torch.Tensor) -> torch.Tensor:
        for lvl in range(self.L + 1, self.R):
            f = self.level(f"likelihood.level{lvl}",
                           torch.cat([_up2(f), enc[self.R - 1 - lvl]], dim=1))
        return self.conv("likelihood.logits", f, 1)


def nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# Training: GECO
# ---------------------------------------------------------------------------


def f32_mode() -> None:
    """Float32 convolutions and matmuls: TF32 off in cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _kl(mu_q, ls_q, mu_p, ls_p) -> torch.Tensor:
    """Analytic KL of two diagonal Gaussians, summed an image, batch mean."""
    b = mu_q.shape[0]
    per = ls_p - ls_q + (torch.exp(2 * ls_q) + (mu_q - mu_p).square()) / (2 * torch.exp(2 * ls_p)) - 0.5
    return per.reshape(b, -1).sum(1).mean()


def train_state(params: Params) -> dict:
    """The moving average's state (hidden value, step count) held in `params`."""
    return {"ma_hidden": params["geco.ma_hidden"].clone().float(),
            "ma_count": params["geco.ma_count"].clone().float()}


def geco_forward(cfg: Mapping, params: Params, x: torch.Tensor, s: torch.Tensor, draw: Draw,
                 generator: Optional[torch.Generator] = None, state: Optional[dict] = None):
    """(loss, summaries, state after) of one training forward: x (B,H,W,C),
    s (B,H,W) labels. The posterior's eps come from draw(mu.shape), NCHW,
    coarsest level first; then one uniform a pixel from `generator` (B*H*W,
    pixel order) for the Gumbel top-k. The summaries are the source's:
    rec_loss_sum, rec_loss_mean, kl_{i} (i from the coarsest), kl_sum,
    ma_rec_loss_mean, num_valid_pixels, lagmul and total_loss, and the
    top-k mask."""
    f32_mode()
    net = Net(cfg, params)
    xc = nchw(x).float()
    s_oh = nchw(F.one_hot(s.long(), cfg["nlabels"]).float())
    post_in = torch.cat([xc, s_oh], dim=1)
    _, zq, mq, lq = net.decode("posterior", net.encode("posterior", post_in),
                               noise=lambda i, mu: draw(tuple(mu.shape)).float())
    enc = net.encode("prior", xc)
    f, _, mp, lp = net.decode("prior", enc, z_in=zq)
    logits = net.stitch(enc, f)                                   # (B, C, H, W)
    b = logits.shape[0]
    xe = -(s_oh * F.log_softmax(logits, dim=1)).sum(1).reshape(-1)
    kls = [_kl(mq[i], lq[i], mp[i], lp[i]) for i in range(len(mq))]
    kl_sum = torch.stack(kls).sum()
    u = torch.rand(xe.shape, generator=generator, device=xe.device)
    sg = xe.detach()
    score = torch.log(sg / sg.sum()) - torch.log(-torch.log(u + 1e-20) + 1e-20)
    k = int(math.floor(xe.numel() * TOP_K_SHARE))
    mask = torch.zeros_like(sg).index_fill_(0, torch.topk(score, k).indices, 1.0)
    rec_sum = (mask * xe).reshape(b, -1).sum(1).mean()
    rec_mean = (mask * xe).sum() / mask.sum()
    n_valid = mask.reshape(b, -1).sum(1).mean()
    state = train_state(params) if state is None else state
    hidden = DECAY * state["ma_hidden"] + (1 - DECAY) * rec_sum.detach()
    count = state["ma_count"] + 1
    ma = hidden / (1 - torch.pow(DECAY, count)) + rec_sum - rec_sum.detach()
    lam = params["geco.lagmul"]
    loss = lam * (ma - KAPPA * n_valid) + kl_sum
    summaries = {"rec_loss_sum": rec_sum, "rec_loss_mean": rec_mean, "kl_sum": kl_sum,
                 **{f"kl_{i}": kl for i, kl in enumerate(kls)},
                 "ma_rec_loss_mean": ma / n_valid, "num_valid_pixels": n_valid, "lagmul": lam,
                 "total_loss": loss, "mask": mask}
    return loss, summaries, {"ma_hidden": hidden.detach(), "ma_count": count}


def grad_step(cfg: Mapping, params: Params, x: torch.Tensor, s: torch.Tensor, draw: Draw,
              generator: Optional[torch.Generator] = None, state: Optional[dict] = None):
    """(summaries, gradients by name, state after): every trainable name's
    gradient of the loss; the multiplier's scaled by -RATE, as its
    optimiser step takes it (gradient ascent)."""
    names = trainable(param_spec(cfg))
    leaves = {n: params[n].detach().requires_grad_(True) for n in names}
    with torch.enable_grad():
        loss, summaries, state = geco_forward(cfg, dict(params, **leaves), x, s, draw, generator,
                                              state)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names], allow_unused=True)
    out = {n: (torch.zeros_like(leaves[n]) if g is None else g) for n, g in zip(names, grads)}
    out["geco.lagmul"] = -RATE * out["geco.lagmul"]
    return {k: v.detach() for k, v in summaries.items()}, out, state


class Adam:
    """Adam (beta 0.9 / 0.999, eps 1e-8 added to the bias-corrected root)
    over `names`, then the multiplier clamped at >= 0 (GECO's projection)."""

    def __init__(self, params: Params, names: Sequence[str]):
        self.names = list(names)
        self.m = {n: torch.zeros_like(params[n]) for n in self.names}
        self.v = {n: torch.zeros_like(params[n]) for n in self.names}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Params, grads: Mapping[str, torch.Tensor], lr: float) -> None:
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        for n in self.names:
            g = grads[n]
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[n] / (1 - b2 ** self.t)).sqrt() + eps
            params[n].sub_(lr * (self.m[n] / (1 - b1 ** self.t)) / denom)
        params["geco.lagmul"].clamp_(min=0.0)


# ---------------------------------------------------------------------------
# Prior sampling
# ---------------------------------------------------------------------------


@torch.no_grad()
def sample_probs(cfg: Mapping, params: Params, x: torch.Tensor,
                 eps: Sequence[torch.Tensor]) -> torch.Tensor:
    """Softmax probabilities (S, B, H, W, C) of S prior draws an image: the
    prior's encoder once, its features tiled to S x B rows (row s B + b
    holds image b), every draw decoded to full resolution. eps finest first,
    (S, B, h, w, zdim) a latent level."""
    f32_mode()
    net = Net(cfg, params)
    xc = nchw(x).float()
    b, S = xc.shape[0], eps[0].shape[0]
    enc = [t.repeat(S, 1, 1, 1) for t in net.encode("prior", xc)]
    rows = [nchw(e.float().reshape(S * b, *e.shape[2:])) for e in eps][::-1]  # coarsest first
    f, _, _, _ = net.decode("prior", enc, noise=lambda i, mu: rows[i])
    probs = torch.softmax(net.stitch(enc, f), dim=1)
    return probs.reshape(S, b, *probs.shape[1:]).permute(0, 1, 3, 4, 2)
