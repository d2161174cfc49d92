#!/usr/bin/env python3
"""Time design variants of K2, the fused residual-CE backward, on one CUDA card.

  python3 scripts/k2_variants.py [--parent-source OLD.cu] [--out logs/k2_variants.json]

Builds phiseg_tpu_torch/csrc/fused_residual_ce.cu once per pixels-a-thread
width of K2's vector instantiation (as it is, kBwdPx = 2, and a copy with
kBwdPx = 4; the nvcc processes run together) and prints ptxas's registers
and spills for K2. The variants:
  scalar    one pixel a thread, element accesses (the instantiation for odd
            H*W and misaligned tensors), forced on the main shape;
  px2, px4  the vector instantiation at 2 and 4 pixels a thread;
  parent    with --parent-source, K2 of another revision of the same file
            with the earlier C entry point (one thread per pixel on a 1D
            grid), e.g. `git show HEAD~1:phiseg_tpu_torch/csrc/fused_residual_ce.cu`.
Each variant is held against the plain version at the main-path shape (L=5,
B=12, 128x128, C=2, f32) in both memory layouts of the levels (gradient abs
<= 1e-5, bitwise rerun) and timed as chip_smoke.py phase 2 times K2: device
time with the host kept ahead, L2-warm, and L2-cold after a 128 MB write or
read between calls with the flush's own time subtracted. Each measurement
runs the variants in turns, forward then backward (a, b, ..., b, a), and
averages each variant's two runs. Needs a card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (the repository root's timing helpers)

PXS = (2, 4)
PX_LINE = "constexpr int kBwdPx = 2;"
SHAPE = (5, 12, 128, 2)  # L, B, H=W, C


def _build_all(parent_source):
    """nvcc of every build at once; returns {name: (library path, ptxas text)}."""
    from phiseg_tpu_torch.ops import cuda_build
    from phiseg_tpu_torch.ops import fused_residual_ce as frce

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    text = frce.SOURCE.read_text()
    if PX_LINE not in text:
        cs.fail(f"{frce.SOURCE} no longer holds {PX_LINE!r}")
    sources = {f"px{px}": text.replace(PX_LINE, f"constexpr int kBwdPx = {px};") for px in PXS}
    if parent_source:
        with open(parent_source) as f:
            sources["parent"] = f.read()
    procs = {}
    for name, src in sources.items():
        stem = cuda_build.BUILD_DIR / f"k2_variant_{name}_{os.getpid()}"
        stem.with_suffix(".cu").write_text(src)
        procs[name] = (stem, subprocess.Popen(
            [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(stem.with_suffix(".so")),
             str(stem.with_suffix(".cu"))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    built = {}
    for name, (stem, proc) in procs.items():
        _, err = proc.communicate()
        stem.with_suffix(".cu").unlink()
        if proc.returncode != 0:
            cs.fail(f"nvcc of {name} failed:\n{err}")
        built[name] = (stem.with_suffix(".so"), err)
    return built


def _launcher(path, variant):
    """fn(inp, s_oh, g) -> L gradients, launching K2 of the library at
    `path` as `variant`."""
    import torch

    from phiseg_tpu_torch.ops import fused_residual_ce as frce

    if variant == "parent":
        lib = ctypes.CDLL(str(path))
        lib.frce_backward.argtypes = [ctypes.POINTER(ctypes.c_void_p)] * 2 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.frce_backward.restype = ctypes.c_int
    else:
        lib = frce.bind(path)

    def fn(inp, s_oh, g):
        levels = frce._levels_nchw(inp)
        first = levels[0]
        b, nclass, h, w = first.shape
        planes = frce._planes(levels)
        shape = (len(levels), b, nclass, h, w) if planes else (len(levels), b, h, w, nclass)
        grads = torch.empty(shape, dtype=first.dtype, device=first.device)
        grads = list((grads if planes else grads.permute(0, 1, 4, 2, 3)).unbind(0))
        last = (frce._num_blocks(first.device, b * h * w) if variant == "parent"
                else int(variant != "scalar"))  # the grid, or the vector switch
        stream = torch.cuda.current_stream(first.device).cuda_stream
        err = lib.frce_backward(frce._pointers(levels), frce._pointers(grads), len(levels),
                                int(planes), s_oh.data_ptr(), g.data_ptr(), h * w, b * h * w,
                                nclass, b, int(first.dtype == torch.bfloat16), last, stream)
        if err:
            cs.fail(f"K2 {variant} launch failed: CUDA error {err}")
        return grads

    return fn


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-source", help="another revision of csrc/fused_residual_ce.cu")
    ap.add_argument("--out", default=os.path.join(ROOT, "logs", "k2_variants.json"))
    args = ap.parse_args()
    smi = cs.phase_device()
    import torch

    from phiseg_tpu_torch.ops import fused_residual_ce as frce

    built = _build_all(args.parent_source)
    regs = {}
    for name, (_, ptxas) in built.items():
        for kernel, n, spill in cs._ptxas_report(ptxas):
            if kernel.startswith("frce_bwd_kernel"):
                regs[f"{name}: {kernel}"] = (n, spill)
                cs.say(f"ptxas {name}: {kernel}: {n} registers; {spill}")
    variants = {"scalar": _launcher(built["px2"][0], "scalar")}
    for px in PXS:
        variants[f"px{px}"] = _launcher(built[f"px{px}"][0], f"px{px}")
    if "parent" in built:
        variants["parent"] = _launcher(built["parent"][0], "parent")

    levels, b, hw, nclass = SHAPE
    logits, s_oh = cs._case(levels, b, hw, nclass, torch.float32, seed=0)
    w = torch.ones(levels, device="cuda")
    ref_in = logits.clone().requires_grad_(True)
    (ref_g,) = torch.autograd.grad(frce.residual_ce_plain(ref_in, s_oh), ref_in, grad_outputs=w)
    scratch = torch.empty(32 * 2 ** 20, device="cuda")  # 128 MiB, over twice the 50 MB L2
    flushes = {"write": lambda: scratch.fill_(1.0), "read": lambda: scratch.sum()}
    names = list(variants)
    result = {"device": smi, "shape": dict(zip(("L", "B", "HW", "C"), SHAPE)), "ptxas": regs,
              "times": {}}
    for layout, form in (("planes", "levels"), ("rows", "rows")):
        inp = cs._as_form(logits, form)
        for name, fn in variants.items():
            got, again = fn(inp, s_oh, w), fn(inp, s_oh, w)
            torch.cuda.synchronize()
            err = (torch.stack([t.permute(0, 2, 3, 1) for t in got]) - ref_g).abs().max().item()
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            cs.say(f"check {name} {layout}: grad abs {err:.3e} (tol 1e-5), bitwise rerun {same}")
            if not (err <= 1e-5 and same):
                cs.fail(f"K2 {name} disagrees with the plain version in {layout}")
        calls = {n: (lambda fn=fn: fn(inp, s_oh, w)) for n, fn in variants.items()}
        order = names + names[::-1]
        runs = {"warm": [cs.device_ms(calls[n]) for n in order]}
        for flush in ("write", "read"):
            runs[f"cold_{flush}"] = [cs._cold_pair(calls[n], flushes[flush])[0] for n in order]
        for n in names:
            i, j = order.index(n), len(order) - 1 - order.index(n)
            t = {k: (v[i] + v[j]) / 2 for k, v in runs.items()}
            t["runs"] = {k: (v[i], v[j]) for k, v in runs.items()}
            result["times"][f"{n} {layout}"] = t
            cs.say(f"time K2 {n}, {layout}: {t['cold_write']:.4f} ms L2-cold by a 128 MB write "
                   f"({t['runs']['cold_write'][0]:.4f}, {t['runs']['cold_write'][1]:.4f}), "
                   f"{t['cold_read']:.4f} ms by a read, {t['warm']:.4f} ms L2-warm "
                   f"({t['runs']['warm'][0]:.4f}, {t['runs']['warm'][1]:.4f}); device ms, "
                   f"CUDA events, host kept ahead")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    for out, _ in built.values():
        os.unlink(out)
    cs.say(smi)


if __name__ == "__main__":
    main()
