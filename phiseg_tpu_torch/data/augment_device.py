"""On-device data augmentation (port of phiseg_tpu/data/augment_device.py:29-157).

Elastic deformation, scale-crop and rotation compose into ONE backward
coordinate map per image, followed by a single bilinear resample with zero
fill; flips come last as exact reversals. Labels are warped as one-hot and
argmax'd. The work is split in two so each half can be held against the
reference:

  draw_params         the random draws, from a torch.Generator, per image;
  coords_from_params  the backward coordinate map (ys, xs) they define;
  apply_augmentation  the warp on given coordinates, then the flips.

Gating follows the reference distributions: the geometric transforms fire
together with probability 1/augment_every_nth (batch_provider.py:193-194),
each flip independently with 1/max(2, augment_every_nth) (:252-264).

The JAX package's warp is a hat-matrix contraction, a TPU workaround for
slow gathers; here it is a 4-corner gather with the same weights.

The elastic field is a (2, 3, 3) N(0, 10) draw per image, upsampled to
(H, W) as jax.image.resize(method="bicubic") does it: Keys' cubic with
a = -0.5 at half-pixel centres, the weights of each output pixel
renormalised over the taps inside the input (scale_and_translate).
F.interpolate's bicubic (a = -0.75, clamped indices) is another function,
so the resize is the two weight matrices of `bicubic_resize_matrix`,
applied as Wy @ d @ Wx^T.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from phiseg_tpu_torch.data.batch_provider import canonicalise_aug_options
from phiseg_tpu_torch.nn.layers import resize_matrix
from phiseg_tpu_torch.nn.losses import one_hot


def bilinear_warp(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Sample img (B,H,W,C) at float coords ys/xs (B,H,W); zero outside.

    The weights are the reference's hat functions max(0, 1 - |coord - k|)
    at the two neighbouring pixels, and a sample whose coordinate leaves
    [0, H-1] x [0, W-1] is zeroed (augment_device.py:53-60), which
    grid_sample's zero padding would instead blend with the edge.
    """
    b, h, w, c = img.shape
    img = img.float()
    y0f, x0f = torch.floor(ys), torch.floor(xs)
    wy0 = torch.clamp(1.0 - torch.abs(ys - y0f), min=0.0)
    wy1 = torch.clamp(1.0 - torch.abs(ys - (y0f + 1.0)), min=0.0)
    wx0 = torch.clamp(1.0 - torch.abs(xs - x0f), min=0.0)
    wx1 = torch.clamp(1.0 - torch.abs(xs - (x0f + 1.0)), min=0.0)
    y0 = y0f.long().clamp(0, h - 1)
    y1 = (y0f.long() + 1).clamp(0, h - 1)
    x0 = x0f.long().clamp(0, w - 1)
    x1 = (x0f.long() + 1).clamp(0, w - 1)
    flat = img.reshape(b, h * w, c)

    def gather(yi, xi):
        idx = (yi * w + xi).reshape(b, h * w, 1).expand(b, h * w, c)
        return torch.gather(flat, 1, idx).reshape(b, h, w, c)

    top = wx0[..., None] * gather(y0, x0) + wx1[..., None] * gather(y0, x1)
    bot = wx0[..., None] * gather(y1, x0) + wx1[..., None] * gather(y1, x1)
    out = wy0[..., None] * top + wy1[..., None] * bot
    valid = (ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1)
    return torch.where(valid[..., None], out, torch.zeros_like(out))


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel with a = -0.5 (jax.image's "bicubic")."""
    x = x.abs()
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def bicubic_resize_matrix(in_size: int, out_size: int,
                          device: Optional[torch.device] = None) -> torch.Tensor:
    """(out_size, in_size) f32 weights W with resize(v) = W @ v along one
    axis, as jax.image.resize(method="bicubic") builds them
    (nn.layers.resize_matrix with Keys' kernel)."""
    return resize_matrix(in_size, out_size, _keys_cubic, device)


@functools.lru_cache(maxsize=16)
def _resize_matrices(in_hw: Tuple[int, int], out_hw: Tuple[int, int],
                     device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Wy, Wx) of bicubic_resize_matrix, built once per shape and device."""
    return tuple(bicubic_resize_matrix(i, o, device) for i, o in zip(in_hw, out_hw))


def elastic_field(d: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The coarse field d (B, 2, 3, 3) bicubically upsampled to (B, 2, H, W):
    channel 0 displaces x, channel 1 y (augment_device.py:78-83)."""
    wy, wx = _resize_matrices(tuple(d.shape[-2:]), (h, w), d.device)
    return torch.einsum("hk,bckl,wl->bchw", wy, d.float(), wx)


def draw_params(batch: int, h: int, w: int, opts: Mapping[str, Any],
                generator: Optional[torch.Generator] = None,
                device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
    """Per-image random draws of the reference's augmentation (f32 / bool,
    (B,)); with do_elasticaug also "elastic", the (B, 2, 3, 3) N(0, 10)
    coarse field."""
    every_nth = int(opts.get("augment_every_nth", 2))
    kw = dict(generator=generator, device=device)
    short = min(h, w)
    offset = int(float(opts.get("offset", 30)))
    degrees = float(opts.get("rot_degrees", 10.0))
    flip_p = 1.0 / max(2, every_nth)
    r = torch.randint(max(short - offset, 1), short + 1, (batch,), **kw).float()
    params = {
        "do_geom": torch.randint(0, every_nth, (batch,), **kw) == 0,
        "angle": torch.deg2rad((torch.rand(batch, **kw) * 2.0 - 1.0) * degrees),
        "r": r,
        "px": torch.floor(torch.rand(batch, **kw) * (w - r + 1.0)),
        "py": torch.floor(torch.rand(batch, **kw) * (h - r + 1.0)),
        "fliplr": torch.rand(batch, **kw) < flip_p,
        "flipud": torch.rand(batch, **kw) < flip_p,
    }
    if opts.get("do_elasticaug", False):
        params["elastic"] = 10.0 * torch.randn((batch, 2, 3, 3), **kw)
    return params


def coords_from_params(params: Mapping[str, torch.Tensor], h: int, w: int,
                       opts: Mapping[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward coordinate map (ys, xs), each (B,H,W) f32: the elastic
    field, then scale-crop, then rotation about the image centre
    (augment_device.py:78-111). The remap convention is out(p) = in(p + d(p))."""
    geom = params["do_geom"]
    b = geom.shape[0]
    dev = geom.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None].expand(b, h, w)
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :].expand(b, h, w)
    g = geom[:, None, None]
    if opts.get("do_elasticaug", False):
        # the field is gated by the coin as a product, as in JAX
        d_full = elastic_field(params["elastic"] * geom.float()[:, None, None, None], h, w)
        xx = xx + d_full[:, 0]
        yy = yy + d_full[:, 1]
    if opts.get("do_scaleaug", False):
        r = params["r"][:, None, None]
        xx = torch.where(g, params["px"][:, None, None] + xx * (r / w), xx)
        yy = torch.where(g, params["py"][:, None, None] + yy * (r / h), yy)
    if opts.get("do_rotations", False):
        ang = (params["angle"] * geom.float())[:, None, None]
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        dxc, dyc = xx - cx, yy - cy
        cos, sin = torch.cos(ang), torch.sin(ang)
        xx = cx + cos * dxc - sin * dyc
        yy = cy + sin * dxc + cos * dyc
    return yy, xx


def apply_augmentation(x: torch.Tensor, s_oh: torch.Tensor, ys: Optional[torch.Tensor],
                       xs: Optional[torch.Tensor], fliplr: Optional[torch.Tensor] = None,
                       flipud: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp x (B,H,W,C) and s_oh (B,H,W,L) jointly at (ys, xs) (None = no
    warp), then flip per image where fliplr / flipud (B,) are set."""
    if ys is not None:
        both = bilinear_warp(torch.cat([x.float(), s_oh], dim=-1), ys, xs)
        x_out, s_out = both[..., : x.shape[-1]].to(x.dtype), both[..., x.shape[-1]:]
    else:
        x_out, s_out = x, s_oh
    # flips last, as exact reversals (ref batch_provider.py:252-264)
    for flag, dim in ((fliplr, 2), (flipud, 1)):
        if flag is not None:
            f = flag[:, None, None, None]
            x_out = torch.where(f, x_out.flip(dim), x_out)
            s_out = torch.where(f, s_out.flip(dim), s_out)
    return x_out, s_out


def make_augment_fn(opts: Mapping[str, Any], nlabels: int):
    """Batch augmentation fn(x (B,H,W,C), s (B,H,W) int, generator) -> (x, s)."""
    opts = canonicalise_aug_options(opts)
    any_warp = any(opts.get(k, False) for k in ("do_rotations", "do_scaleaug", "do_elasticaug"))

    def augment(x: torch.Tensor, s: torch.Tensor, generator: Optional[torch.Generator] = None):
        b, h, w = s.shape
        params = draw_params(b, h, w, opts, generator, x.device)
        ys, xs = coords_from_params(params, h, w, opts) if any_warp else (None, None)
        x_out, s_oh = apply_augmentation(
            x, one_hot(s, nlabels), ys, xs,
            params["fliplr"] if opts.get("do_fliplr", False) else None,
            params["flipud"] if opts.get("do_flipud", False) else None,
        )
        return x_out, torch.argmax(s_oh, dim=-1).to(s.dtype)

    return augment
