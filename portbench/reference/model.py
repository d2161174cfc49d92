"""Plain PyTorch reference of the two model families the benchmark runs:
PHiSeg (a hierarchy of L spatial latents) and the Probabilistic U-Net (one
global latent), as baumgach/PHiSeg-code defines them (phiseg/models/
posteriors.py, priors.py, likelihoods.py; phiseg_model.py for the losses).

Functional, NCHW, float32 by default. Parameters live in a flat dict whose
names and shapes are `param_spec`'s; the benchmark makes their values from
its seed and hands the same dict to the program under test (by name) and to
this module. Nothing here imports the program.

`Prec` sets the precision of every convolution: "f32" (the reference; the
caller turns TF32 off), "bf16" (inputs, weights, outputs and each block's
result rounded to bfloat16, as the program's bf16 blocks cast them) or "fp8"
(inputs and weights rounded to float8 e4m3 with a per-tensor scale), the
last being the control that a sound program must beat. Batch norm, the
losses, softmax and the metrics compute in float32 in every mode.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import AdamStep

BN_EPS = 1e-3  # tf.layers.batch_normalization's epsilon in the source

Params = Dict[str, torch.Tensor]
Draw = Callable[[Tuple[int, ...]], torch.Tensor]


def channels(n0: int, resolution_levels: int) -> List[int]:
    """Filters per resolution level: n0, 2n0, 4n0, then 6n0 (posteriors.py)."""
    mults = [1, 2, 4] + [6] * max(0, resolution_levels - 3)
    return [n0 * m for m in mults[:resolution_levels]]


class Prec:
    """Rounding of a convolution's input and weight."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def out(self, t: torch.Tensor) -> torch.Tensor:
        """A convolution's output or a block's result: rounded in "bf16"."""
        return t.to(torch.bfloat16).float() if self.mode == "bf16" else t

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.mode == "bf16":
            return t.to(torch.bfloat16).float()
        if self.mode == "fp8":
            scale = 448.0 / t.detach().abs().amax().clamp_min(1e-30)
            return (t * scale).to(torch.float8_e4m3fn).float() / scale
        return t


# ---------------------------------------------------------------------------
# Parameter names and shapes
# ---------------------------------------------------------------------------


def _block(spec: list, name: str, cin: int, cout: int, k: int = 3, norm: bool = True,
           init: str = "conv") -> None:
    spec.append((f"{name}.conv.weight", (cout, cin, k, k), init))
    if norm:
        spec.append((f"{name}.bn.weight", (cout,), "one"))
        spec.append((f"{name}.bn.bias", (cout,), "zero"))
        spec.append((f"{name}.bn.running_mean", (cout,), "zero"))
        spec.append((f"{name}.bn.running_var", (cout,), "one"))
    else:
        spec.append((f"{name}.conv.bias", (cout,), "zero"))


def _tower(spec: list, prefix: str, cin: int, ch: Sequence[int]) -> None:
    for i, c in enumerate(ch):
        for k in range(3):
            _block(spec, f"{prefix}.level{i}_conv{k}", cin, c)
            cin = c


def _hierarchy(spec: list, prefix: str, zdim: int, n0: int, L: int, ch: Sequence[int]) -> None:
    D = len(ch) - L
    for i in range(L):
        head_in = ch[i + D] if i == L - 1 else ch[i]
        _block(spec, f"{prefix}.z{i}_head.mu", head_in, zdim, k=3 if i == L - 1 else 1, norm=False,
               init="head")
        _block(spec, f"{prefix}.z{i}_head.sigma", head_in, zdim, k=1, norm=False, init="head")
    for i in range(L - 1):
        _block(spec, f"{prefix}.z{i}_ups_conv0", zdim, zdim * n0)
        _block(spec, f"{prefix}.z{i}_ups_conv1", zdim * n0, zdim * n0)
        _block(spec, f"{prefix}.z{i}_input_conv0", ch[i + D] + zdim * n0, ch[i])
        _block(spec, f"{prefix}.z{i}_input_conv1", ch[i], ch[i])


def _post_c_channels(ch: Sequence[int], L: int) -> List[int]:
    D = len(ch) - L
    return [ch[i + D] for i in range(L - 1)] + [ch[L - 1]]


def param_spec(cfg: Mapping) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every parameter and batch-norm statistic.
    init: "conv" (He normal), "head" (a Gaussian head's kernel: He normal
    scaled by HEAD_SCALE), "one" or "zero"."""
    if cfg["norm"] != "batch":
        raise NotImplementedError(f"the reference has batch norm only, not {cfg['norm']!r}")
    R, n0, zdim, nl = cfg["resolution_levels"], cfg["n0"], cfg["zdim0"], cfg["nlabels"]
    cin = cfg["image_size"][2]
    ch = channels(n0, R)
    spec: list = []
    if cfg["model_family"] == "phiseg":
        L = cfg["latent_levels"]
        D = R - L
        _tower(spec, "posterior.tower", cin + nl, ch)
        _hierarchy(spec, "posterior.hierarchy", zdim, n0, L, ch)
        _tower(spec, "prior.tower", cin, ch)
        _hierarchy(spec, "prior.hierarchy", zdim, n0, L, ch)
        pc = _post_c_channels(ch, L)
        for i in range(L):
            _block(spec, f"likelihood.z{i}_post0", zdim, ch[i])
            _block(spec, f"likelihood.z{i}_post1", ch[i], ch[i])
            for k in range(D):
                _block(spec, f"likelihood.z{i}_preups{k}", ch[i], ch[i])
        for i in range(L - 1):
            _block(spec, f"likelihood.post_c{i}_ups", pc[i + 1], ch[i])
            _block(spec, f"likelihood.post_c{i}_merge0", 2 * ch[i], ch[i + D])
            _block(spec, f"likelihood.post_c{i}_merge1", ch[i + D], ch[i + D])
        for i in range(L):
            _block(spec, f"likelihood.out{i}", pc[i], nl, k=1, norm=False)
    elif cfg["model_family"] == "prob_unet":
        for prefix, c in (("posterior", cin + nl), ("prior", cin)):
            _tower(spec, f"{prefix}.encoder.tower", c, ch)
            _block(spec, f"{prefix}.encoder.pre_mu", ch[-1], zdim, k=1, norm=False, init="head")
            _block(spec, f"{prefix}.encoder.pre_sigma", ch[-1], zdim, k=1, norm=False, init="head")
        _tower(spec, "likelihood.unet.encoder", cin, ch)
        c = ch[R - 1]
        for jj in range(R - 1):
            c += ch[R - jj - 2]
            for k in range(3):
                _block(spec, f"likelihood.unet.dec{jj}_conv{k}", c, ch[R - jj - 1])
                c = ch[R - jj - 1]
        c = ch[1] + zdim
        for k in range(3):
            _block(spec, f"likelihood.recomb{k}", c, n0, k=1)
            c = n0
        _block(spec, "likelihood.prediction", n0, nl, k=1, norm=False)
    else:
        raise NotImplementedError(f"no reference for model family {cfg['model_family']!r}")
    return spec


def latent_shapes(cfg: Mapping, batch: int) -> List[Tuple[int, ...]]:
    """Each latent level's shape, finest first, channels last as the
    program draws its sampler noise: (B, h, w, zdim) or (B, zdim)."""
    if cfg["model_family"] == "prob_unet":
        return [(batch, cfg["zdim0"])]
    R, L = cfg["resolution_levels"], cfg["latent_levels"]
    h, w = cfg["image_size"][:2]
    shapes = []
    for i in range(R):
        if i >= R - L:
            shapes.append((batch, h, w, cfg["zdim0"]))
        h, w = -(-h // 2), -(-w // 2)
    return shapes


# ---------------------------------------------------------------------------
# The network
# ---------------------------------------------------------------------------


def _up2(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 at half-pixel centres, edges clamped (tf.image.resize_bilinear
    with half-pixel centres, as the JAX rebuild and the port define it)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def _pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pooling with SAME padding (zeros on the high edge of an odd side)."""
    h, w = x.shape[-2:]
    if h % 2 or w % 2:
        x = F.pad(x, (0, w % 2, 0, h % 2))
    return F.avg_pool2d(x, 2, 2)


class Net:
    """The parameters, batch-norm mode (batch statistics in training, the
    running ones otherwise) and convolution precision of one evaluation."""

    def __init__(self, cfg: Mapping, params: Params, training: bool, prec: str = "f32"):
        self.cfg = cfg
        self.p = params
        self.training = training
        self.q = Prec(prec)
        R = cfg["resolution_levels"]
        self.ch = channels(cfg["n0"], R)
        self.L = cfg["latent_levels"] if cfg["model_family"] == "phiseg" else 1
        self.D = R - self.L

    def block(self, name: str, x: torch.Tensor, k: int = 3, act: Optional[str] = "relu",
              norm: bool = True) -> torch.Tensor:
        y = self.q.out(F.conv2d(self.q(x), self.q(self.p[f"{name}.conv.weight"]),
                                self.p.get(f"{name}.conv.bias"), padding=k // 2))
        if norm:
            y = self.q.out(self.bn(f"{name}.bn", y))
        if act == "relu":
            y = F.relu(y)
        elif act == "softplus":
            y = self.q.out(F.softplus(y))
        return y

    def bn(self, name: str, y: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = y.mean(dim=(0, 2, 3), keepdim=True)
            var = (y - mean).square().mean(dim=(0, 2, 3), keepdim=True)  # biased
        else:
            mean = self.p[f"{name}.running_mean"].view(1, -1, 1, 1)
            var = self.p[f"{name}.running_var"].view(1, -1, 1, 1)
        w = self.p[f"{name}.weight"].view(1, -1, 1, 1)
        b = self.p[f"{name}.bias"].view(1, -1, 1, 1)
        return (y - mean) * torch.rsqrt(var + BN_EPS) * w + b

    def tower(self, prefix: str, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for i in range(len(self.ch)):
            if i > 0:
                x = _pool2(x)
            for k in range(3):
                x = self.block(f"{prefix}.level{i}_conv{k}", x)
            feats.append(x)
        return feats

    # -- PHiSeg ------------------------------------------------------------

    def hierarchy(self, prefix: str, pre_z: Sequence[torch.Tensor], draw: Optional[Draw] = None,
                  z_chain: Optional[Sequence[torch.Tensor]] = None):
        """Coarse-to-fine chain: level i < L-1 reads the upsampled z of level
        i+1 (the posterior's own under teacher forcing). Returns (z, mu,
        sigma), finest first; noise comes from draw(mu.shape) per level,
        coarsest first, and none is drawn under teacher forcing."""
        L, D = self.L, self.D
        z: List[Optional[torch.Tensor]] = [None] * L
        mu: List[Optional[torch.Tensor]] = [None] * L
        sigma: List[Optional[torch.Tensor]] = [None] * L
        for i in reversed(range(L)):
            if i == L - 1:
                feats = pre_z[i + D]
            else:
                zb = _up2(z_chain[i + 1] if z_chain is not None else z[i + 1])
                zb = self.block(f"{prefix}.z{i}_ups_conv1", self.block(f"{prefix}.z{i}_ups_conv0", zb))
                feats = torch.cat([pre_z[i + D], zb], dim=1)
                feats = self.block(f"{prefix}.z{i}_input_conv0", feats)
                feats = self.block(f"{prefix}.z{i}_input_conv1", feats)
            mu[i] = self.block(f"{prefix}.z{i}_head.mu", feats, k=3 if i == L - 1 else 1, act=None,
                               norm=False)
            sigma[i] = self.block(f"{prefix}.z{i}_head.sigma", feats, k=1, act="softplus", norm=False)
            if z_chain is None:
                z[i] = mu[i] + sigma[i] * draw(tuple(mu[i].shape))
        return z, mu, sigma

    def phiseg_likelihood(self, z: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Per-level logits at the image size, finest first."""
        L, D = self.L, self.D
        post_z = []
        for i in range(L):
            net = self.block(f"likelihood.z{i}_post1", self.block(f"likelihood.z{i}_post0", z[i]))
            for k in range(D):
                net = self.block(f"likelihood.z{i}_preups{k}", _up2(net))
            post_z.append(net)
        post_c = [None] * L
        post_c[L - 1] = post_z[L - 1]
        for i in reversed(range(L - 1)):
            ups = self.block(f"likelihood.post_c{i}_ups", _up2(post_c[i + 1]))
            net = self.block(f"likelihood.post_c{i}_merge0", torch.cat([post_z[i], ups], dim=1))
            post_c[i] = self.block(f"likelihood.post_c{i}_merge1", net)
        size = tuple(self.cfg["image_size"][:2])
        return [F.interpolate(self.block(f"likelihood.out{i}", post_c[i], k=1, act=None, norm=False),
                              size=size, mode="nearest-exact") for i in range(L)]

    # -- Probabilistic U-Net -------------------------------------------------

    def global_gaussian(self, prefix: str, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mu, sigma), each (B, zdim): 1x1 heads on the deepest feature,
        softplus before the global average pool, as the source has it."""
        feats = self.tower(f"{prefix}.tower", x)[-1]
        mu = self.block(f"{prefix}.pre_mu", feats, k=1, act=None, norm=False).mean(dim=(2, 3))
        sigma = self.block(f"{prefix}.pre_sigma", feats, k=1, act="softplus", norm=False).mean(dim=(2, 3))
        return mu, sigma

    def unet(self, x: torch.Tensor) -> torch.Tensor:
        R = len(self.ch)
        enc = self.tower("likelihood.unet.encoder", x)
        net = enc[-1]
        for jj in range(R - 1):
            net = torch.cat([_up2(net), enc[R - jj - 2]], dim=1)
            for k in range(3):
                net = self.block(f"likelihood.unet.dec{jj}_conv{k}", net)
        return net

    def unet_tail(self, feats: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        b, _, h, w = feats.shape
        net = torch.cat([feats, z[:, :, None, None].expand(b, z.shape[1], h, w)], dim=1)
        for k in range(3):
            net = self.block(f"likelihood.recomb{k}", net, k=1)
        return self.block("likelihood.prediction", net, k=1, act=None, norm=False)


# ---------------------------------------------------------------------------
# Training forward and objective
# ---------------------------------------------------------------------------


def train_forward(net: Net, x: torch.Tensor, s_oh: torch.Tensor, draw: Draw):
    """x (B,C,H,W), s_oh (B,nlabels,H,W) -> (per-level logits, q_mu,
    q_sigma, p_mu, p_sigma): the posterior samples z, the prior is
    teacher-forced with them, the likelihood decodes them."""
    inp = torch.cat([x, s_oh - 0.5], dim=1)
    if net.cfg["model_family"] == "phiseg":
        z, q_mu, q_sig = net.hierarchy("posterior.hierarchy", net.tower("posterior.tower", inp), draw)
        _, p_mu, p_sig = net.hierarchy("prior.hierarchy", net.tower("prior.tower", x), z_chain=z)
        return net.phiseg_likelihood(z), q_mu, q_sig, p_mu, p_sig
    q_mu, q_sig = net.global_gaussian("posterior.encoder", inp)
    z = q_mu + q_sig * draw(tuple(q_mu.shape))
    p_mu, p_sig = net.global_gaussian("prior.encoder", x)
    return [net.unet_tail(net.unet(x), z)], [q_mu], [q_sig], [p_mu], [p_sig]


def kl_diag(mu0, s0, mu1, s1) -> torch.Tensor:
    """KL(N(mu0, s0^2) || N(mu1, s1^2)), summed per image, batch mean, with
    the source's +1e-10 guards (phiseg_model.py)."""
    b = mu0.shape[0]
    mu0, mu1, s0, s1 = (t.reshape(b, -1) for t in (mu0, mu1, s0, s1))
    s0sq, s1sq = s0.square(), s1.square()
    per = 0.5 * ((s0sq + (mu1 - mu0).square()) / (s1sq + 1e-10)
                 + torch.log(s1sq + 1e-10) - torch.log(s0sq + 1e-10) - 1.0).sum(dim=1)
    return per.mean()


def objective(cfg: Mapping, params: Params, outs, s_oh: torch.Tensor) -> torch.Tensor:
    """The total loss: the residual multinoulli loss (level i's CE is on the
    sum of the logits of levels i..L-1, pixel-summed, batch-meaned), the
    4^i-weighted KL, and the L2 weight decay where the config has one."""
    logits, q_mu, q_sig, p_mu, p_sig = outs
    total = torch.zeros((), device=s_oh.device)
    if cfg.get("residual_multinoulli_loss_weight") is not None:
        acc, ce = None, 0.0
        for i in reversed(range(len(logits))):
            acc = logits[i] if acc is None else acc + logits[i]
            ce = ce + (-(s_oh * F.log_softmax(acc, dim=1)).sum(dim=1)).flatten(1).sum(1).mean()
        total = total + cfg["residual_multinoulli_loss_weight"] * ce
    if cfg.get("kl_divergence_loss_weight") is not None:
        kl = 0.0
        for i in range(len(q_mu)):
            w = 4.0 ** i if cfg.get("exponential_weighting", True) else 1.0
            kl = kl + w * kl_diag(q_mu[i], q_sig[i], p_mu[i], p_sig[i])
        total = total + cfg["kl_divergence_loss_weight"] * kl
    if cfg.get("weight_decay_weight") is not None:
        wd = sum(0.5 * p.square().sum() for n, p in params.items() if n.endswith("conv.weight"))
        total = total + cfg["weight_decay_weight"] * wd
    return total


def lr_at(cfg: Mapping, step: int) -> float:
    """The learning-rate schedule: the value of the largest threshold <= step."""
    sched = sorted((int(k), float(v)) for k, v in cfg["lr_schedule"].items())
    lr = sched[0][1]
    for k, v in sched:
        if k <= step:
            lr = v
    return lr


def train_state(cfg: Mapping, params: Params) -> None:
    """Both families carry no train state from step to step."""
    return None


def optimizer(cfg: Mapping, params: Params, names: Sequence[str]) -> AdamStep:
    """Both families train with Adam alone, at lr_at."""
    return AdamStep(lambda step: lr_at(cfg, step), params, names)


def trainable(spec) -> List[str]:
    """The names that training moves (batch-norm running statistics are not)."""
    return [n for n, _, _ in spec if "running_" not in n]


def nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def one_hot_nchw(s: torch.Tensor, nlabels: int) -> torch.Tensor:
    return nchw(F.one_hot(s.long(), nlabels).float())


def grad_step(cfg: Mapping, params: Params, x: torch.Tensor, s: torch.Tensor, draw: Draw,
              prec: str = "f32", generator: Optional[torch.Generator] = None, state=None):
    """One training forward and backward: x (B,H,W,C) float and s (B,H,W)
    integer labels, already augmented. Returns (loss, gradients by name,
    state): both families draw only normals, through `draw`, and carry no
    train state, so `generator` is not read and `state` passes through."""
    names = trainable(param_spec(cfg))
    leaves = {n: params[n].detach().requires_grad_(True) for n in names}
    p = dict(params, **leaves)
    s_oh = one_hot_nchw(s, cfg["nlabels"])
    with torch.enable_grad():
        loss = objective(cfg, p, train_forward(Net(cfg, p, True, prec), nchw(x).float(), s_oh, draw),
                         s_oh)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names], allow_unused=True)
    return loss.detach(), {n: (torch.zeros_like(leaves[n]) if g is None else g)
                           for n, g in zip(names, grads)}, state


# ---------------------------------------------------------------------------
# Prior sampling
# ---------------------------------------------------------------------------


@torch.no_grad()
def sample_probs(cfg: Mapping, params: Params, x: torch.Tensor, eps: Sequence[torch.Tensor],
                 prec: str = "f32") -> torch.Tensor:
    """Softmax probabilities (S, B, H, W, C) of S prior draws per image, in
    eval batch norm. x (B,H,W,C); eps per latent level, finest first, as
    `latent_shapes` with a leading S (S, B, h, w, zdim) or (S, B, zdim)."""
    net = Net(cfg, params, False, prec)
    xc = nchw(x).float()
    b, S = xc.shape[0], eps[0].shape[0]

    def rows(e: torch.Tensor) -> torch.Tensor:  # draw s of image b at row s*B + b
        e = e.float().reshape(S * b, *e.shape[2:])
        return nchw(e) if e.ndim == 4 else e

    if cfg["model_family"] == "phiseg":
        pre = [t.repeat(S, 1, 1, 1) if i >= net.D else None
               for i, t in enumerate(net.tower("prior.tower", xc))]
        it = iter([rows(e) for e in eps][::-1])  # the chain draws coarsest first
        z, _, _ = net.hierarchy("prior.hierarchy", pre, lambda shape: next(it))
        logits = net.phiseg_likelihood(z)
        total = logits[0]
        for t in logits[1:]:
            total = total + t
    else:
        mu, sigma = net.global_gaussian("prior.encoder", xc)
        z = mu.repeat(S, 1) + sigma.repeat(S, 1) * rows(eps[0])
        total = net.unet_tail(net.unet(xc).repeat(S, 1, 1, 1), z)
    probs = torch.softmax(total, dim=1)  # (S*B, C, H, W)
    return probs.reshape(S, b, *probs.shape[1:]).permute(0, 1, 3, 4, 2)


# The Gaussian heads' kernels start at a quarter of He normal's scale, so
# that the untrained model's sigmas sit near softplus(0) ~ 0.69, as in a model
# past its first steps: at full He scale some prior sigmas start deep in
# softplus's exponential tail, where the KL of a few pixels is most of the
# loss and its value in bfloat16 is off float32's by up to a tenth. The
# configuration files' "assumed" weights say so; control.py --head-scale
# reads the check at another scale.
HEAD_SCALE = 0.25


def init_std(shape: Sequence[int], init: str) -> float:
    """The standard deviation of an OIHW kernel's draw: He normal's
    sqrt(2 / fan_in), times HEAD_SCALE for a Gaussian head."""
    std = math.sqrt(2.0 / (shape[1] * math.prod(shape[2:])))
    return std * HEAD_SCALE if init == "head" else std
