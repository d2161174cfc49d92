"""Plain PyTorch reference of the training augmentation: the source's random
flips, rotation and scale-crop (phiseg/data/batch_provider.py), composed
into one backward coordinate map per image and applied as one bilinear
resample with zero fill, flips last.

The draws replay the program's generator: the same generator state, the
same calls in the same order (per image of the batch: the crop side r, the
coin that gates the geometric transforms, the angle, the crop's corner x and
y, the left-right and up-down flip coins), so both sides see the same
transforms. Elastic deformation is not supported: no configuration of the
benchmark turns it on.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch


def _opts(opts: Mapping) -> dict:
    o = dict(opts)
    if "do_flip_lr" in o:
        o.setdefault("do_fliplr", o.pop("do_flip_lr"))
    if "do_flip_ud" in o:
        o.setdefault("do_flipud", o.pop("do_flip_ud"))
    if o.get("do_elasticaug", False):
        raise NotImplementedError("the reference has no elastic deformation")
    return o


def draw(batch: int, h: int, w: int, opts: Mapping, generator: torch.Generator,
         device: torch.device) -> dict:
    """The per-image random draws, in the program's order."""
    every_nth = int(opts.get("augment_every_nth", 2))
    kw = dict(generator=generator, device=device)
    short = min(h, w)
    offset = int(float(opts.get("offset", 30)))
    flip_p = 1.0 / max(2, every_nth)
    r = torch.randint(max(short - offset, 1), short + 1, (batch,), **kw).float()
    geom = torch.randint(0, every_nth, (batch,), **kw) == 0
    angle = torch.deg2rad((torch.rand(batch, **kw) * 2.0 - 1.0) * float(opts.get("rot_degrees", 10.0)))
    px = torch.floor(torch.rand(batch, **kw) * (w - r + 1.0))
    py = torch.floor(torch.rand(batch, **kw) * (h - r + 1.0))
    fliplr = torch.rand(batch, **kw) < flip_p
    flipud = torch.rand(batch, **kw) < flip_p
    return dict(r=r, geom=geom, angle=angle, px=px, py=py, fliplr=fliplr, flipud=flipud)


def coords(d: dict, h: int, w: int, opts: Mapping) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward map (ys, xs), each (B,H,W): out(p) = in(ys(p), xs(p)). The
    crop of side r at (py, px) is scaled to the image, then the image is
    rotated about its centre; both only where the image's coin fell."""
    geom = d["geom"]
    b, dev = geom.shape[0], geom.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None].expand(b, h, w)
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :].expand(b, h, w)
    g = geom[:, None, None]
    if opts.get("do_scaleaug", False):
        r = d["r"][:, None, None]
        xx = torch.where(g, d["px"][:, None, None] + xx * (r / w), xx)
        yy = torch.where(g, d["py"][:, None, None] + yy * (r / h), yy)
    if opts.get("do_rotations", False):
        ang = (d["angle"] * geom.float())[:, None, None]
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        dxc, dyc = xx - cx, yy - cy
        cos, sin = torch.cos(ang), torch.sin(ang)
        xx = cx + cos * dxc - sin * dyc
        yy = cy + sin * dxc + cos * dyc
    return yy, xx


def warp(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of img (B,H,W,C) at (ys, xs), zero where a coordinate
    leaves [0, H-1] x [0, W-1]."""
    b, h, w, c = img.shape
    y0f, x0f = torch.floor(ys), torch.floor(xs)
    wy0 = torch.clamp(1.0 - torch.abs(ys - y0f), min=0.0)
    wy1 = torch.clamp(1.0 - torch.abs(ys - (y0f + 1.0)), min=0.0)
    wx0 = torch.clamp(1.0 - torch.abs(xs - x0f), min=0.0)
    wx1 = torch.clamp(1.0 - torch.abs(xs - (x0f + 1.0)), min=0.0)
    y0 = y0f.long().clamp(0, h - 1)
    y1 = (y0f.long() + 1).clamp(0, h - 1)
    x0 = x0f.long().clamp(0, w - 1)
    x1 = (x0f.long() + 1).clamp(0, w - 1)
    bi = torch.arange(b, device=img.device)[:, None, None]

    def at(yi, xi):
        return img[bi, yi, xi]  # (B,H,W,C)

    top = wx0[..., None] * at(y0, x0) + wx1[..., None] * at(y0, x1)
    bot = wx0[..., None] * at(y1, x0) + wx1[..., None] * at(y1, x1)
    out = wy0[..., None] * top + wy1[..., None] * bot
    valid = (ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1)
    return torch.where(valid[..., None], out, torch.zeros_like(out))


def augment(x: torch.Tensor, s: torch.Tensor, nlabels: int, opts: Mapping,
            generator: Optional[torch.Generator]) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,H,W,C) float, s (B,H,W) integer -> the augmented pair: the image
    and the one-hot labels warped together, flipped, the labels argmax'd."""
    opts = _opts(opts)
    b, h, w = s.shape
    d = draw(b, h, w, opts, generator, x.device)
    s_oh = torch.nn.functional.one_hot(s.long(), nlabels).float()
    both = torch.cat([x.float(), s_oh], dim=-1)
    if any(opts.get(k, False) for k in ("do_rotations", "do_scaleaug")):
        both = warp(both, *coords(d, h, w, opts))
    for key, flag, dim in (("do_fliplr", d["fliplr"], 2), ("do_flipud", d["flipud"], 1)):
        if opts.get(key, False):
            both = torch.where(flag[:, None, None, None], both.flip(dim), both)
    c = x.shape[-1]
    return both[..., :c], torch.argmax(both[..., c:], dim=-1)

