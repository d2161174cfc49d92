#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

  python3 chip_smoke.py          # from the repository root, on a machine with a card

Phases, each fatal on failure:
  0. device: require CUDA, print the card's name and power limit, set and
     print the TF32 switches;
  1. build the fused residual-CE kernels from phiseg_tpu_torch/csrc/ and
     print ptxas's registers and spills per kernel;
  2. hold K1 (forward) and K2 (backward) against their plain PyTorch version
     at the main-path shape in every input form and memory layout (the
     stacked (L,B,H,W,C) tensor, NHWC views of NCHW levels, levels
     contiguous in NHWC), f32 and bf16, and at edge shapes: the scalar
     instantiations (H*W = 81, misaligned levels), C = 1, 3, 4 and L = 8 in
     both layouts; each line names the instantiations launched; require
     bitwise-equal reruns and the logits' dtype in the gradient; the same at
     the U-Net families' shape, L=1 (f32 and bf16 levels, f32 rows); time
     kernel vs plain at the main-path shape (L=5) and at L=1 in both
     layouts: device time with the host kept ahead, L2-warm and L2-cold (a
     128 MB write, or read, between calls, its own time subtracted), and per
     call by CUDA events; at L=1 also F.cross_entropy with probability
     targets and its autograd backward, the one PyTorch call that computes
     K1's (K2's) function there, held against the kernels and timed as they
     are;
  3. train `phiseg_7_5_synth` at full width (R=7, L=5, n0=32, 128x128,
     batch 12, bf16, BN, Adam, on-device augmentation) through
     phiseg_tpu_torch.cli.train.main for NUM_STEPS steps; check every logged
     loss is finite, that each kernel launched once per step, and that the
     parameters moved and stay finite;
  4. from one saved state, one noise draw and one augmentation draw, run
     one full-width step with the fused kernels and one with the plain
     version; the loss dicts and the gradients agree. Then the step's CE in
     context, on the model's own level tensors: forward + backward from the
     likelihood's L output convolutions (through its resize and f32 cast)
     and from its L f32 levels, each by the kernels as the objective calls
     them, by `torch.stack` then the kernels (the layout before the kernels
     read the levels in place), and by the plain version; all agree, device
     time of each;
  5. data parallel, two gloo ranks sharing the card (NCCL refuses two ranks
     on one device), `phiseg_7_5_synth` at full width with the global batch
     of 12 split 6 + 6: one f32 step and one f64 step from a saved state
     with injected noise and no augmentation, each held against the 1-rank
     step on the whole batch (losses, gradients before the optimiser, BN
     running statistics; f64 tensor by tensor, f32 by the all-parameter
     relative L2, with each f32 step's distance from the f64 one printed);
     the 2-rank sharded sampler against the unsharded one; K3 against the
     plain version of the global batch, timed; then DP_STEPS bf16 steps with
     augmentation through the Trainer with a mesh: losses finite, K1, K2 and
     K3 launched once per step on each rank, rank states bitwise equal;
  6. `--mesh 1` through the train CLI for 3 steps: one rank on NCCL, K1, K2
     and K3 launched once per step in it;
  7. the 100-sample prior sampler on the model trained in phase 3, for
     B=1 and B=8: ms/image (device time with the host kept ahead, and per
     call) and the peak device memory;
  8. `phiseg_7_5_synth` at full width through the train CLI with validation
     every 10 steps for 21 steps (two validations over the 32 synthetic val
     images, 16 samples, 16 ELBO draws), then the same command to 26 steps:
     train and validation scalars finite, the latest / best_* checkpoints
     and best_metrics.json written, best_* tags of one step sharing an
     inode, K1 launched once a step plus 2 + 16 times in each validation
     (the two eval-loss calls and the ELBO draws), K2 once a step; a Trainer
     built on the log dir holds the first run's model, Adam state, step and
     generator bit for bit, and the second run starts at step 21; seconds,
     peak device memory and GED^2 / S_NCC / Dice / -ELBO of each validation;
  9. K1 on the validation path in the config's bf16 compute: every K1 call
     of make_validation_fn over one full batch of 32 val images (the 16
     ELBO draws) and of one make_eval_loss_fn call at the train batch, on
     phase 8's model, held level by level against the plain CE of the same
     card tensors at phase 2's tolerance for the levels' dtype; then make_validation_fn and
     make_eval_loss_fn on the card (K1) and on the CPU (plain CE), 4 val
     images, the same injected noise, both f32 with TF32 off: masks equal
     but at near-ties (pixels that differ printed), Dice, GED^2, S_NCC, the
     ELBO and the eval loss's per-level CE within VAL_TOL; the same sample
     probabilities in f64 on both (model.double()) within F64_GAP; GED^2 of
     fixed 128x128 masks equal with TF32 on and under bf16 autocast;
 10. `test_quantitative` on phase 8's best_ged through its CLI, 100 samples,
     batch 8, the 32 synthetic test images: the npz contract (keys, shapes,
     n_samples, n_annotators, finite values), s/image of wall time, device
     ms/image with the host kept ahead, peak device memory;
 11. `probunet_synth` and `detunet_synth` at full width (R=7, n0=32,
     zdim0=6, 128x128, batch 12, bf16, BN, Adam, on-device augmentation;
     DetUNet on annotator 0 without the KL) through the train CLI, VAL_ITERS
     steps validating every VAL_FREQ: losses finite with JAX's keys,
     parameters moved, best_* checkpoints, K1 (at L=1) once a step plus 18
     times a validation and K2 once a step, the one level read in place,
     median step time and peak memory; for ProbUNet a kernel step against a
     plain step as in phase 4, and the sampler as in phase 7;
 12. `test_predictions` through its CLI on best_dice of phase 8's PHiSeg log
     dir and of phase 11's two (100 samples; DetUNet forced to 1): the npz
     contract ((32, 2), finite, in [0, 1]), s/image of wall time, device
     ms/image with the host kept ahead, peak device memory;
 13. the other norms, `phiseg_7_5_synth` at full width with norm group,
     layer, instance and renorm: NORM_STEPS steps with augmentation through
     make_train_step (losses finite, every parameter tensor moved, K1 and K2
     once a step, renorm's step counters at NORM_STEPS), median step time
     and peak memory; a kernel step against a plain step (losses within
     KERNEL_STEP_LOSS_TOL); one f64 step on the card against the CPU with the
     same weights and noise (NORM_F64_TOL);
 14. elastic augmentation: one batch warped on the card and on the CPU with
     the same injected draws (field, scale, rotation, flips): images within
     ELASTIC_IMAGE_ATOL, labels equal but where the warped one-hot ties
     (counted); the augmentation's device ms with and without the field;
     ELASTIC_STEPS steps with do_elasticaug on, K1 and K2 once a step;
 15. the step profiler: PROFILE_ITERS steps through the train CLI with
     PHISEG_PROFILE_DIR and PHISEG_PROFILE_STEPS; its one Chrome trace read
     back: nonzero device time, K1 and K2 by their kernel names once per
     traced step, the window's device-busy share and top device operations;
 16. test_quantitative and test_predictions through their CLIs with
     `--mesh 2` (two gloo ranks sharing the card) and `--mesh 1` (one NCCL
     rank) on phase 8's best weights in f32 with TF32 off: GED^2, S_NCC and
     Dice equal within MESH_TOL;
 17. the figure CLIs: generate_samples on phase 8's PHiSeg and phase 11's
     ProbUNet, sample_construction and makegif_samples on the PHiSeg: their
     compute on the card against the CPU in f64 with the same noise, its ms
     per image on the card, and each CLI end to end (files read back) where
     matplotlib / PIL are installed, which the phase decides and prints
     before it starts any;
 18. the LIDC data path at full width: a fake pickle of Stefan Knegt's LIDC
     crops' structure (LIDC_PATIENTS patients x LIDC_LESIONS lesions,
     128x128 f64 images, 4 annotator discs), read by the chunked reader and
     split by patient in memory (split_lidc; the phase does not need h5py,
     and prints whether it is importable), the split held to prepare_data's
     HDF5 contract; the registry's `phiseg_7_5` itself through the Trainer on
     LIDCData.from_splits, VAL_ITERS steps validating every VAL_FREQ, then
     `probunet` and `detunet` LIDC_FAMILY_ITERS steps each: losses finite,
     parameters moved, the f64 batches reaching the model as f32 on the card
     computed in the config's dtype, K1 once a step plus 2 + the ELBO draws
     a validation, K2 once a step, best_* checkpoints, median step time, peak
     memory, each validation's seconds and metrics; HOST_AUG_STEPS phiseg_7_5
     steps fed by numpy/scipy augmentation on the host (its ms per batch, the
     step time, K1 and K2 once a step); the 100-sample inference of the
     trained PHiSeg on LIDC_SAMPLE_IMAGES test images through
     InferenceEngine: ms/image and peak memory;
 19. a checkpoint written by phiseg_tpu: the committed fixture
     tests/data/jax_checkpoint_small restored on the card by load_experiment,
     its sample probabilities and eval losses from the stored noise against
     the JAX package's within JAX_CKPT_TOL (f32, TF32 off), then
     test_quantitative through its CLI on that log dir (npz contract);
 20. norm="batch_bf16" at full width: `phiseg_7_5_synth` (R=7, L=5, n0=32,
     128x128, batch 12, bf16, on-device augmentation) BF16_STEPS steps
     through the Trainer, in turns with norm="batch" (batch, bf16, bf16,
     batch): losses finite, every parameter moved, K1 and K2 once a step,
     the median step time of each run; then one step with "batch" (twice,
     for the spread of the card's bf16 atomics) and one with "batch_bf16"
     from one saved state, noise draw and augmentation draw: losses within
     BF16_STEP_LOSS_TOL, the shared parameters' gradients (all-parameter
     relative L2) within 3x the batch-vs-batch spread + 1e-3;
 21. a phiseg_tpu run carried on: the committed log dirs
     tests/data/jax_logdir_resume/{detunet,detunet_batches,phiseg} (a tiny
     DetUNet on one batch, the same on four, and a PHiSeg that phiseg_tpu's
     Trainer trained to step 3, scripts/make_jax_resume_fixture.py) copied
     under logs/chip_smoke/ and resumed by the port's Trainer on the card in
     f32, TF32 off, to step 6 (detunet_batches to 5). First, from each
     resumed state, one step with the kernels against two with the plain CE
     at the run's own shapes (L=2 for the PHiSeg, 16x16, batch 4), held as
     in phase 13 (losses within KERNEL_STEP_LOSS_TOL). Then the run: the
     `.msgpack` step, Adam state, K1 (one a step + the step-4 validation's
     calls) and K2 (one a step) launches, finite losses, `.pt` latest at the
     last step, the `.msgpack` and config.json unchanged; each DetUNet's
     losses within JAX_RESUME_RTOL of the JAX Trainer's resumed run
     (expected.npz, steps 3-5; expected_batches.npz, steps 3-4, the batches
     the stream gives a resumed run).

Spawned ranks have a join timeout; a rank that fails or hangs fails the run.
The second-to-last line is a JSON object with one entry per kernel; the last
is {"ok": true, "device": {...}}. Artifacts go to logs/chip_smoke/.
"""

from __future__ import annotations

import copy
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

NUM_STEPS = 30
DP_STEPS = 10
DP_WORLD = 2
RANK_TIMEOUT = 420  # seconds for a spawn of ranks, start to join
SAMPLES = 100
EXPERIMENT = "phiseg_7_5_synth"
ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "logs", "chip_smoke")
KERNEL_SOURCE = "phiseg_tpu_torch/csrc/fused_residual_ce.cu"
DP_SOURCE = "phiseg_tpu_torch/ops/fused_residual_ce.py"
TPU_KERNELS = {"fwd": "phiseg_tpu/ops/fused_residual_ce.py:42",
               "bwd": "phiseg_tpu/ops/fused_residual_ce.py:76",
               "dp": "phiseg_tpu/ops/fused_residual_ce.py:191"}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_OPS_PER_S = 67e12      # f32 outside the tensor cores


def bound_ms(nbytes: float, ops: float):
    """The least time for the work: bytes over HBM rate vs operations over
    the f32 rate, the larger; and which one it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ce_work(levels: int, pixels: int, nclass: int, with_grad: bool):
    """Bytes K1 (or K2) must move and operations it does at these shapes:
    read the logits and the one-hot once (K2 also writes the gradient);
    per level and pixel about 6C+2 operations (accumulate, max, exp, sum,
    log, the label's dot; K2 the softmax and the running sum)."""
    nbytes = (levels * pixels * nclass + pixels * nclass) * 4 + levels * 4
    if with_grad:
        nbytes += levels * pixels * nclass * 4
    return nbytes, levels * pixels * (6 * nclass + 2)
# (rtol of the forward, atol of the gradient) per logits dtype. f32: the
# per-level sums run over ~2e5 pixels in another order than the plain
# version's, while the gradient is elementwise. bf16: the plain version
# accumulates the levels in bf16, the kernel in f32
# (scripts/pallas_tpu_parity.py).
TOLERANCE = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 5e-2)}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(*args) -> None:
    print(*args, flush=True)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Median milliseconds of one fn() call by CUDA events around it. The
    stream is idle at each start, so this includes the host's time to issue
    the call's launches."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, iters: int = 10, warmup: int = 5, sleep_cycles: int = 200_000_000) -> float:
    """Device milliseconds per fn() call. A sleep kernel holds the stream
    while the host queues all the calls, so the CUDA events around them time
    back-to-back device work and none of the host's issue time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)  # 200M cycles: ~0.1 s of device clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    if start.query():
        fail("the host fell behind the device while queueing the timed calls")
    end.synchronize()
    return start.elapsed_time(end) / iters


# a Chrome trace's device events: kernels, copies and fills
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _trace_events(path: str):
    """The complete ("X") events of a Chrome trace and its device events."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    return events, [e for e in events if e.get("cat") in DEVICE_CATS]


def _kernel_ms(fn, iters: int = 10) -> float:
    """Milliseconds of device work per fn() call: the durations of the
    kernels, copies and fills in torch.profiler's trace of `iters` calls
    after one warm-up, so the host's pace does not enter. Only the trace's
    device events count: key_averages() also gives the CPU op that launched
    a kernel that kernel's time, and its overhead rows a device type."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    path = os.path.join(OUT_DIR, "kernel_ms_trace.json")
    prof.export_chrome_trace(path)
    _, device = _trace_events(path)
    os.remove(path)
    return sum(e["dur"] for e in device) / 1e3 / iters


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this check runs only on a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    say(f"tf32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    return smi


def _ptxas_report(text: str):
    """(kernel, registers, spill line) per kernel entry in ptxas -v output,
    the kernel named as K1 kernel<type, classes, pixels a thread> or K2
    kernel<type, classes, layout, pixels a thread>."""
    import re

    rows, name = [], None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            k = re.search(r"(frce_\w+?_kernel)I(f|13__nv_bfloat16)Li(\d)E(?:Lb([01])E)?"
                          r"(?:Li(\d)E)?", m.group(1))
            name = m.group(1)
            if k:  # K2 has a layout parameter (Lb1E planes, Lb0E rows); K1 has none
                layout = {None: "", "1": "planes, ", "0": "rows, "}[k.group(4)]
                name = (f"{k.group(1)}<{'f32' if k.group(2) == 'f' else 'bf16'}, C={k.group(3)}, "
                        f"{layout}{'vec' if k.group(4) is None else 'px'}={k.group(5) or 1}>")
            spill = "no spill line"
        elif name and "spill" in ln:
            spill = ln.strip()
        elif name and "Used" in ln:
            regs = int(re.search(r"Used (\d+) registers", ln).group(1))
            rows.append((name, regs, spill))
            name = None
    return rows


def phase_build():
    from phiseg_tpu_torch.ops import fused_residual_ce as frce

    t0 = time.perf_counter()
    frce._library()
    rows = _ptxas_report(str(frce.BUILD_INFO.get("ptxas", "")))
    spills = [r for r in rows if not r[2].startswith("0 bytes stack frame, 0 bytes spill")]
    say(f"build: {time.perf_counter() - t0:.3f} s (nvcc {frce.BUILD_INFO.get('seconds', 0):.3f} s, "
        f"{len(rows)} kernels, {len(spills)} with a stack frame or spills)")
    for name, regs, spill in rows:
        say(f"  ptxas {name}: {regs} registers; {spill}")
    return rows


def _case(levels, b, hw, nclass, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    logits = (torch.randn(levels, b, hw, hw, nclass, device="cuda", generator=g) * 3.0).to(dtype)
    labels = torch.randint(0, nclass, (b, hw, hw), device="cuda", generator=g)
    s_oh = torch.nn.functional.one_hot(labels, nclass).float()
    return logits, s_oh


def _as_form(logits, form: str):
    """The (L,B,H,W,C) logits as a caller hands them to the kernels: the
    stacked tensor; NHWC views of L NCHW tensors ("levels"); L tensors
    contiguous in NHWC ("rows"), as a channels-last model hands them out; or
    rows one element off an aligned address ("rows+1")."""
    import torch

    if form == "stacked":
        return logits
    if form == "levels":
        return [lv.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1) for lv in logits]
    if form == "rows":
        return [lv.contiguous() for lv in logits]
    out = []
    for lv in logits:
        t = torch.empty(lv.numel() + 1, dtype=lv.dtype, device=lv.device)[1:].view(lv.shape)
        out.append(t.copy_(lv))
    return out


def _variant(inp, s_oh) -> str:
    """Which K1 and K2 instantiations the wrappers launch for these inputs,
    and the levels' memory layout. K2's choice is made on the levels; its
    gradients, one fresh allocation in the levels' layout, are aligned
    whenever H*W is a multiple of the pixels a thread."""
    from phiseg_tpu_torch.ops import fused_residual_ce as frce

    levels = frce._levels_nchw(inp)
    _, nclass, h, w = levels[0].shape
    ptrs, item = [t.data_ptr() for t in levels], levels[0].element_size()
    planes = frce._planes(levels)
    k1 = frce.vector_kernel_fits(h * w, ptrs, item, s_oh.data_ptr())
    k2 = frce.backward_vector_fits(h * w, nclass, planes, ptrs, item, s_oh.data_ptr())
    return (f"K1 {'vector' if k1 else 'scalar'}, K2 "
            f"{f'vector ({frce.BWD_PX} px)' if k2 else 'scalar'}, {'planes' if planes else 'rows'}")


def _cold_pair(fn, flush, iters: int = 20):
    """Device ms of fn() with the L2 cache flushed before each call: the
    time of flush + fn less that of flush alone, in the order flush,
    flush + fn, flush + fn, flush. Returns (ms, flush ms)."""
    both = lambda: (flush(), fn())  # noqa: E731
    dev = [device_ms(f, iters=iters) for f in (flush, both, both, flush)]
    return (dev[1] + dev[2]) / 2 - (dev[0] + dev[3]) / 2, (dev[0] + dev[3]) / 2


def _time_vs(fn, other_fn, flushes):
    """Device ms of fn(): L2-warm in turns with other_fn (other, fn, fn,
    other; "other" is the mean of other_fn's two runs), L2-cold after a 128 MB
    write and after a 128 MB read, and per call with the host's issue."""
    dev = [device_ms(f) for f in (other_fn, fn, fn, other_fn)]
    t = {"warm": (dev[1] + dev[2]) / 2, "other": (dev[0] + dev[3]) / 2, "runs": dev}
    t["cold"], t["flush"] = _cold_pair(fn, flushes["write"])
    t["cold_read"], t["flush_read"] = _cold_pair(fn, flushes["read"])
    t["call"], t["call_other"] = cuda_ms(fn), cuda_ms(other_fn)
    return t


def _library_at_l1(flushes):
    """At L=1 the residual CE is plain cross-entropy, which one PyTorch call
    computes: F.cross_entropy with probability targets on the NCHW level, and
    its autograd backward. Held against K1 and K2 on the same tensors (phase
    2's timed L=1 case, f32 planes), then timed as they are, in turns with
    them."""
    import torch
    import torch.nn.functional as F

    from phiseg_tpu_torch.ops import fused_residual_ce as frce

    logits, s_oh = _case(1, 12, 128, 2, torch.float32, seed=0)
    levels = _as_form(logits, "levels")
    b = logits.shape[1]
    x = levels[0].permute(0, 3, 1, 2)  # the NCHW tensor under the NHWC view
    target = s_oh.permute(0, 3, 1, 2).contiguous()
    leaf = x.detach().clone().requires_grad_(True)
    loss = F.cross_entropy(leaf, target, reduction="sum") / b
    (grad,) = torch.autograd.grad(loss, leaf, retain_graph=True)
    w = torch.ones(1, device="cuda")
    k1 = frce.fused_residual_ce_forward(levels, s_oh)
    k2 = frce.fused_residual_ce_backward(levels, s_oh, w)[0]
    fwd_rel = abs(loss.item() - k1[0].item()) / abs(k1[0].item())
    grad_abs = (grad.permute(0, 2, 3, 1) - k2).abs().max().item()
    rtol, atol = TOLERANCE["float32"]
    say(f"library at L1 B12 128x128 C2 f32 planes: F.cross_entropy(level_nchw, s_oh_nchw, "
        f"reduction='sum') / B vs K1 rel {fwd_rel:.3e} (tol {rtol:g}); its autograd gradient vs "
        f"K2 abs {grad_abs:.3e} (tol {atol:g})")
    if not (fwd_rel <= rtol and grad_abs <= atol):
        fail("F.cross_entropy and the kernels compute different functions at L=1")

    def lib_fwd():
        with torch.no_grad():
            return F.cross_entropy(x, target, reduction="sum") / b

    fns = {"fwd": ("F.cross_entropy", lib_fwd,
                   lambda: frce.fused_residual_ce_forward(levels, s_oh)),
           "bwd": ("its autograd backward, graph retained",
                   lambda: torch.autograd.grad(loss, leaf, retain_graph=True),
                   lambda: frce.fused_residual_ce_backward(levels, s_oh, w))}
    out = {}
    for k, (what, lib_fn, kernel_fn) in fns.items():
        t = out["library", k] = _time_vs(lib_fn, kernel_fn, flushes)
        say(f"time library {k} at L1 B12 128x128 C2 f32 ({what}): "
            f"device {t['cold']:.4f} ms L2-cold (write flush), {t['cold_read']:.4f} ms (read "
            f"flush), {t['warm']:.4f} ms L2-warm vs the kernel's {t['other']:.4f} ms in turns "
            f"(runs {', '.join(f'{d:.4f}' for d in t['runs'])}); per call incl. host issue "
            f"{t['call']:.4f} ms vs the kernel's {t['call_other']:.4f} ms")
    return out


def phase_kernels():
    import torch

    from phiseg_tpu_torch.ops import fused_residual_ce as frce

    cases = [  # name, L, B, HW, C, dtype, per-level weights, input form
        ("main f32", 5, 12, 128, 2, torch.float32, None, "stacked"),
        ("main bf16", 5, 12, 128, 2, torch.bfloat16, None, "stacked"),
        ("L1", 1, 2, 16, 2, torch.float32, None, "stacked"),
        ("L3 weighted", 3, 2, 16, 2, torch.float32, [1.0, 2.0, 0.5], "stacked"),
        ("P300", 3, 3, 10, 2, torch.float32, [1.0, 2.0, 0.5], "stacked"),
        ("main f32 levels", 5, 12, 128, 2, torch.float32, None, "levels"),
        ("main bf16 levels", 5, 12, 128, 2, torch.bfloat16, None, "levels"),
        ("main f32 rows", 5, 12, 128, 2, torch.float32, None, "rows"),
        ("hw9 levels", 3, 2, 9, 2, torch.float32, [1.0, 2.0, 0.5], "levels"),
        ("hw9 bf16 stacked", 3, 2, 9, 2, torch.bfloat16, [1.0, 2.0, 0.5], "stacked"),
        ("main f32 rows+1", 5, 12, 128, 2, torch.float32, None, "rows+1"),
        ("main bf16 rows", 5, 12, 128, 2, torch.bfloat16, None, "rows"),
        ("C1 levels", 3, 2, 16, 1, torch.float32, [1.0, 2.0, 0.5], "levels"),
        ("C1 bf16 rows", 3, 2, 16, 1, torch.bfloat16, [1.0, 2.0, 0.5], "rows"),
        ("C3 levels", 3, 2, 16, 3, torch.float32, [1.0, 2.0, 0.5], "levels"),
        ("C3 rows", 3, 2, 16, 3, torch.float32, [1.0, 2.0, 0.5], "rows"),
        ("C3 bf16 rows", 3, 2, 16, 3, torch.bfloat16, [1.0, 2.0, 0.5], "rows"),
        ("C4 levels", 3, 2, 16, 4, torch.float32, [1.0, 2.0, 0.5], "levels"),
        ("C4 bf16 rows", 3, 2, 16, 4, torch.bfloat16, [1.0, 2.0, 0.5], "rows"),
        ("hw9 C3 rows", 3, 2, 9, 3, torch.float32, [1.0, 2.0, 0.5], "rows"),
        ("C3 rows+1", 3, 2, 16, 3, torch.float32, [1.0, 2.0, 0.5], "rows+1"),
        ("L8 levels", 8, 2, 16, 2, torch.float32, [1.0, 2.0, 0.5, 1.5, 0.25, 3.0, 1.0, 2.0],
         "levels"),
        ("L8 C4 bf16 rows", 8, 12, 16, 4, torch.bfloat16, None, "rows"),
        # the U-Net families' shape: one level (phase 11)
        ("L1 main f32 levels", 1, 12, 128, 2, torch.float32, None, "levels"),
        ("L1 main bf16 levels", 1, 12, 128, 2, torch.bfloat16, None, "levels"),
        ("L1 main f32 rows", 1, 12, 128, 2, torch.float32, None, "rows"),
    ]
    errs = {}
    for i, (name, levels, b, hw, nclass, dtype, w, form) in enumerate(cases):
        logits, s_oh = _case(levels, b, hw, nclass, dtype, seed=i)
        inp = _as_form(logits, form)
        w = torch.tensor(w or [1.0] * levels, device="cuda")
        out = frce.fused_residual_ce_forward(inp, s_oh)
        grad = frce.fused_residual_ce_backward(inp, s_oh, w)
        out2 = frce.fused_residual_ce_forward(inp, s_oh)
        grad2 = frce.fused_residual_ce_backward(inp, s_oh, w)
        ref_in = logits.clone().requires_grad_(True)
        ref = frce.residual_ce_plain(ref_in, s_oh)
        (ref_grad,) = torch.autograd.grad(ref, ref_in, grad_outputs=w)
        torch.cuda.synchronize()
        same = torch.equal(out, out2) and all(torch.equal(x, y) for x, y in zip(grad, grad2))
        shapes = ([tuple(grad.shape)] if form == "stacked" else [tuple(x.shape) for x in grad]) == (
            [tuple(logits.shape)] if form == "stacked" else [tuple(x.shape) for x in inp])
        dtypes = {x.dtype for x in ([grad] if form == "stacked" else grad)}
        grad = torch.stack(list(grad))
        rtol, atol = TOLERANCE[str(dtype).split(".")[-1]]
        # with C = 1 the CE is exactly 0 in both: the floor keeps 0 / 0 out
        fwd_rel = ((out - ref.detach()).abs() / ref.detach().abs().clamp_min(1e-30)).max().item()
        fwd_abs = (out - ref.detach()).abs().max().item()
        grad_abs = (grad.float() - ref_grad.float()).abs().max().item()
        say(f"kernel check {name} ({form}; {_variant(inp, s_oh)}): fwd rel {fwd_rel:.3e} "
            f"(tol {rtol:g}), grad abs {grad_abs:.3e} (tol {atol:g}), grad dtype "
            f"{sorted(str(d) for d in dtypes)}, shapes as the input's {shapes}, bitwise rerun {same}")
        if not (fwd_rel <= rtol and grad_abs <= atol):
            fail(f"kernel disagrees with its plain version on {name}")
        if dtypes != {logits.dtype} or not shapes or not same:
            fail(f"kernel gradient dtype, shapes or determinism wrong on {name}")
        if name == "main f32":
            errs = {"fwd": fwd_abs, "bwd": grad_abs}

    scratch = torch.empty(32 * 2 ** 20, device="cuda")  # 128 MiB, over twice the 50 MB L2
    flushes = {"write": lambda: scratch.fill_(1.0), "read": lambda: scratch.sum()}
    # (kernel, layout, levels) -> {"warm", "cold", "cold_read", "flush", "plain", ...};
    # ("library", fwd | bwd) -> the same for F.cross_entropy at L=1; "floor"
    times = {}
    for levels in (5, 1):
        logits, s_oh = _case(levels, 12, 128, 2, torch.float32, seed=0)
        w = torch.ones(levels, device="cuda")
        ref_in = logits.clone().requires_grad_(True)
        ref = frce.residual_ce_plain(ref_in, s_oh)

        def plain_fwd():
            with torch.no_grad():
                frce.residual_ce_plain(logits, s_oh)

        read = (logits.numel() + s_oh.numel()) * 4
        moved = {"fwd": read, "bwd": read + logits.numel() * 4}  # bytes the kernel must move
        for layout, form in (("rows", "rows"), ("planes", "levels")):
            inp = _as_form(logits, form)
            fns = {
                "fwd": (lambda: frce.fused_residual_ce_forward(inp, s_oh), plain_fwd),
                "bwd": (lambda: frce.fused_residual_ce_backward(inp, s_oh, w),
                        lambda: torch.autograd.grad(ref, ref_in, grad_outputs=w,
                                                    retain_graph=True)),
            }
            for k, (kernel_fn, plain_fn) in fns.items():
                t = _time_vs(kernel_fn, plain_fn, flushes)
                t["plain"], t["call_plain"] = t["other"], t["call_other"]
                t["variant"] = _variant(inp, s_oh)
                times[k, layout, levels] = t
                say(f"time {k} at L{levels} B12 128x128 C2 f32, {layout} ({t['variant']}): device "
                    f"{t['cold']:.4f} ms L2-cold (a 128 MB write between calls, its "
                    f"{t['flush']:.4f} ms subtracted), {t['cold_read']:.4f} ms L2-cold by a 128 MB "
                    f"read ({t['flush_read']:.4f} ms subtracted), {t['warm']:.4f} ms L2-warm vs "
                    f"{t['plain']:.4f} ms plain (CUDA events, host kept ahead; warm runs "
                    f"{', '.join(f'{d:.4f}' for d in t['runs'])}); per call incl. host issue "
                    f"{t['call']:.4f} ms kernel vs {t['call_plain']:.4f} ms plain (CUDA events, "
                    f"median of 50); kernel moves {moved[k] / 1e6:.2f} MB: "
                    f"{moved[k] / t['cold'] / 1e9:.3f} TB/s cold = "
                    f"{moved[k] / t['cold'] / 1e9 / 3.35:.1%} of the H100's 3.35 TB/s")
    times.update(_library_at_l1(flushes))
    del scratch
    one = torch.zeros(1, device="cuda")
    times["floor"] = device_ms(lambda: one.add_(1.0), iters=20)
    say(f"launch floor: a one-element kernel, back to back, {times['floor']:.4f} ms device per "
        f"call (CUDA events, host kept ahead)")
    return errs, times


def phase_slice():
    import numpy as np
    import torch

    from phiseg_tpu_torch.cli.train import main as train_main
    from phiseg_tpu_torch.engine.train import build_model
    from phiseg_tpu_torch.experiments import get_experiment
    from phiseg_tpu_torch.ops import fused_residual_ce as frce

    cfg = get_experiment(EXPERIMENT).replace(num_iter=NUM_STEPS, tensorboard_update_frequency=1)
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    os.makedirs(OUT_DIR)
    cfg_path = os.path.join(OUT_DIR, "config.json")
    cfg.save(cfg_path)
    log_dir = os.path.join(OUT_DIR, "log")
    say(f"slice: {EXPERIMENT} R={cfg.resolution_levels} L={cfg.latent_levels} n0={cfg.n0} "
        f"{cfg.image_size} batch {cfg.batch_size} {cfg.compute_dtype} norm={cfg.norm} "
        f"{cfg.optimizer} aug={dict(cfg.augmentation_options)}, {NUM_STEPS} steps")

    torch.cuda.reset_peak_memory_stats()
    frce.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = train_main([cfg_path, "--log-dir", log_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(frce.LAUNCHES)

    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    if [r["step"] for r in recs] != list(range(NUM_STEPS)):
        fail(f"metrics.jsonl holds steps {[r['step'] for r in recs]}")
    for r in recs:
        bad = [k for k, v in r.items() if k.startswith("batch_") and not math.isfinite(v)]
        if bad:
            fail(f"non-finite losses at step {r['step']}: {bad}")
    for k in ("fused_residual_ce_fwd", "fused_residual_ce_bwd"):
        if launches[k] != NUM_STEPS:
            fail(f"{k} launched {launches[k]} times in {NUM_STEPS} steps")
    if launches["fused_residual_ce_dp"]:
        fail("K3 launched in a run without a mesh")

    init = build_model(cfg, device="cpu", seed=cfg.seed).state_dict()
    trained = trainer.state.model.state_dict()
    params = [n for n, _ in trainer.state.model.named_parameters()]
    unchanged = [n for n in params if torch.equal(init[n], trained[n].cpu())]
    nonfinite = [n for n, t in trained.items() if not torch.isfinite(t).all()]
    if unchanged or nonfinite:
        fail(f"parameters unchanged: {unchanged[:5]}; non-finite state: {nonfinite[:5]}")

    step_ms = [1000.0 * cfg.batch_size / r["images_per_sec"] for r in recs[2:]]
    med = statistics.median(step_ms)
    say(f"slice losses (step 0 -> {NUM_STEPS - 1}): total {recs[0]['batch_total_loss']:.6g} -> "
        f"{recs[-1]['batch_total_loss']:.6g}, CE lvl0 "
        f"{recs[0]['batch_residual_multinoulli_loss_lvl0']:.6g} -> "
        f"{recs[-1]['batch_residual_multinoulli_loss_lvl0']:.6g}; all finite")
    say(f"slice: {len(params)} parameter tensors all moved and finite; launches {launches}")
    say(f"slice time: median step {med:.3f} ms over steps 2..{NUM_STEPS - 1} "
        f"({1000.0 * cfg.batch_size / med:.2f} img/s, each step synchronised for its log line); "
        f"wall {wall:.2f} s incl. data and first steps; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return launches, cfg, trainer


def _rel_l2(a, b):
    """Relative L2 distance of a from b over all their tensors."""
    return math.sqrt(sum(float((a[n] - b[n]).square().sum()) for n in b)
                     / sum(float(b[n].square().sum()) for n in b))


def phase_in_context(cfg):
    import torch

    from phiseg_tpu_torch.data import get_dataset
    from phiseg_tpu_torch.engine.train import create_train_state

    device = torch.device("cuda")
    data = get_dataset(cfg)
    x, s = data.train.next_batch(cfg.batch_size)
    x = torch.from_numpy(x).to(device)
    s = torch.from_numpy(s.astype("uint8")).to(device)
    init = _kernel_vs_plain_step(cfg, x, s, head="likelihood.out")
    model = create_train_state(cfg, device).model
    model.load_state_dict(init)
    return _ce_in_context(cfg, model, x, s)


def _kernel_vs_plain_step(cfg, x, s, head: str, loss_tol: float = 1e-4, init=None):
    """One step with the fused kernels and two with the plain version, from
    one saved state (`init`, else the config's seeded init), one noise draw
    and one augmentation draw: the loss dicts agree within loss_tol relative
    and the gradients agree (the parameters named `head...`, the
    likelihood's output convolutions, tightly). Returns the state."""
    import torch

    from phiseg_tpu_torch.data.augment_device import make_augment_fn
    from phiseg_tpu_torch.engine.train import create_train_state, make_train_step

    device = x.device
    g = torch.Generator(device=device).manual_seed(7)
    model = create_train_state(cfg, device).model
    eps = [torch.randn(shape, device=device, generator=g, dtype=cfg.dtype)
           for shape in model.latent_shapes(cfg.batch_size)]
    augment_fn = make_augment_fn(cfg.augmentation_options, cfg.nlabels)
    init = model.state_dict() if init is None else init
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for name, fused in (("kernel", True), ("plain", False), ("plain again", False)):
            state = create_train_state(cfg, device)
            state.model.load_state_dict(init)
            step = make_train_step(cfg, augment_fn=augment_fn, use_fused_ce=fused)
            aug_gen = torch.Generator(device=device).manual_seed(8)  # the same augmentation
            losses = {k: float(v) for k, v in step(state, x, s, aug_gen, eps=eps).items()}
            runs[name] = losses, {n: p.grad.float() for n, p in state.model.named_parameters()}
    finally:
        torch.backends.cudnn.deterministic = False
    (ld_k, gr_k), (ld_p, gr_p), (_, gr_p2) = runs["kernel"], runs["plain"], runs["plain again"]
    say(f"{cfg.experiment_name} step, kernel: {json.dumps(ld_k, sort_keys=True)}")
    say(f"{cfg.experiment_name} step, plain:  {json.dumps(ld_p, sort_keys=True)}")
    worst = max(abs(ld_k[k] - ld_p[k]) / abs(ld_p[k]) for k in ld_p)

    # The likelihood's output convolutions take K2's gradient first, before
    # any backward that sums with atomics: they differ only where the
    # kernels' f32 round-off flips a bf16 rounding. Further back, the bf16
    # atomics of the bilinear upsampling's backward make even two plain
    # steps differ, so there the kernel step is held to that spread.
    gr_p_head = {n: gr_p[n] for n in gr_p if n.startswith(head)}
    head_rel, head_noise = _rel_l2(gr_k, gr_p_head), _rel_l2(gr_p2, gr_p_head)
    all_rel, all_noise = _rel_l2(gr_k, gr_p), _rel_l2(gr_p2, gr_p)
    say(f"{cfg.experiment_name} step (augmentation on): worst loss relative difference "
        f"{worst:.3e} (tol {loss_tol:g})")
    say(f"{cfg.experiment_name} step gradients, relative L2, kernel vs plain (plain vs plain): "
        f"output convs ({head}*) "
        f"{head_rel:.3e} ({head_noise:.3e}), tol 1e-3; all parameters {all_rel:.3e} "
        f"({all_noise:.3e}), tol 3x plain vs plain + 1e-3")
    if set(ld_k) != set(ld_p) or not worst <= loss_tol:
        fail("the step with the kernels disagrees with the step with the plain version")
    if not gr_p_head or not (head_rel <= 1e-3 and all_rel <= 3 * all_noise + 1e-3):
        fail("the step's gradients with the kernels disagree with those with the plain version")
    return init


def _ce_in_context(cfg, model, x, s):
    """The step's CE forward + backward on the model's own level tensors,
    from the likelihood's output convolutions (through its resize and f32
    cast) and from its f32 levels, by the kernels as the objective calls
    them, by torch.stack then the kernels, and by the plain version. Holds
    the three to each other and returns the levels' memory layout and the
    device ms of each span and way. The posterior's noise is drawn from a
    generator, as in the train step: the levels' memory layout follows the
    noise's."""
    import torch

    from phiseg_tpu_torch.nn.layers import at_least_f32, nhwc, resize_nearest
    from phiseg_tpu_torch.nn.losses import one_hot
    from phiseg_tpu_torch.ops import fused_residual_ce as frce

    L = cfg.latent_levels
    s_oh = one_hot(s, cfg.nlabels)
    convs = {}
    hooks = [getattr(model.likelihood, f"out{i}").register_forward_hook(
        lambda mod, inp, out, i=i: convs.__setitem__(i, out.detach().clone())) for i in range(L)]
    try:
        with torch.no_grad():
            levels = model(x, s_oh, generator=torch.Generator(device=x.device).manual_seed(9)
                           ).s_out_list
    finally:
        for h in hooks:
            h.remove()
    read = frce._levels_nchw(levels)
    in_place = all(a.data_ptr() == b.data_ptr() for a, b in zip(read, levels))
    layout = "planes" if frce._planes(read) else "rows"
    say(f"in context: the likelihood's {L} f32 levels {tuple(levels[0].shape)} (strides "
        f"{levels[0].stride()}) are {layout} in memory; the kernels read them in place: {in_place}")
    if not in_place:
        fail("the kernels' inputs are a copy of the model's level tensors")

    w = torch.ones(L, device=x.device)
    ce = {"kernels": lambda v: frce.fused_residual_ce(v, s_oh),
          "stack": lambda v: frce.fused_residual_ce(torch.stack(list(v)), s_oh),
          "plain": lambda v: frce.residual_ce_plain(v, s_oh)}
    conv_leaves = [convs[i].requires_grad_(True) for i in range(L)]
    level_leaves = [t.detach().clone().requires_grad_(True) for t in levels]

    def convs_fn(way):  # the likelihood's output convolutions -> their gradients
        per = ce[way]([nhwc(at_least_f32(resize_nearest(t, cfg.image_hw))) for t in conv_leaves])
        return per, torch.autograd.grad(per, conv_leaves, grad_outputs=w)

    def levels_fn(way):  # the f32 levels -> their gradients
        per = ce[way](level_leaves)
        return per, torch.autograd.grad(per, level_leaves, grad_outputs=w)

    times = {}
    spans = {"convs": (convs_fn, f"{cfg.compute_dtype} output convolutions", 1e-2),
             "levels": (levels_fn, "f32 levels", TOLERANCE["float32"][1])}
    for span, (fn, what, gtol) in spans.items():
        outs = {way: fn(way) for way in ce}
        ref_per, ref_g = outs["plain"]
        for way in ("kernels", "stack"):
            per, g = outs[way]
            rel = ((per - ref_per).abs() / ref_per.abs()).max().item()
            gerr = max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                       for a, b in zip(g, ref_g))
            say(f"in context CE from the {what}, {way} vs plain: losses rel {rel:.3e} (tol "
                f"{TOLERANCE['float32'][0]:g}), gradients max|diff|/max|plain| {gerr:.3e} "
                f"(tol {gtol:g})")
            if not (rel <= TOLERANCE["float32"][0] and gerr <= gtol):
                fail(f"in context, the CE by {way} disagrees with the plain version")
        order = ("kernels", "stack", "plain", "plain", "stack", "kernels")
        dev = [device_ms(lambda: fn(way), iters=10, sleep_cycles=1_000_000_000) for way in order]
        t = {way: (dev[order.index(way)] + dev[len(order) - 1 - order.index(way)]) / 2
             for way in ce}
        times[span] = t
        say(f"in context CE forward + backward from the {L} {what} (device ms, CUDA events, host "
            f"kept ahead, runs {', '.join(f'{d:.4f}' for d in dev)}): kernels on the levels in "
            f"place {t['kernels']:.4f}, torch.stack then the kernels {t['stack']:.4f}, plain "
            f"{t['plain']:.4f}")
    times["stack alone"] = device_ms(lambda: torch.stack(list(level_leaves)), iters=20)
    say(f"in context: torch.stack of the {L} f32 levels alone {times['stack alone']:.4f} ms device")
    return layout, times


def _latent_eps(cfg, batch, generator):
    """Posterior noise per level, NHWC, on the CPU in the compute dtype."""
    import torch

    h, w = cfg.image_hw
    R, L = cfg.resolution_levels, cfg.latent_levels
    return [torch.randn(batch, h // 2 ** (i + R - L), w // 2 ** (i + R - L), cfg.zdim0,
                        generator=generator, dtype=cfg.dtype) for i in range(L)]


def _step_once(cfg, init, x, s, eps, device, mesh=None):
    """One train step from the weights `init` on `device`: on the whole
    global batch without a mesh, on this rank's shard with one. With compute
    dtype float64 the model is made f64 and the CE is the plain version
    (the kernels take f32 and bf16). Returns the losses, the gradients
    before the optimiser and the BN running statistics, copied to the CPU."""
    import torch

    from phiseg_tpu_torch.engine.train import create_train_state, make_train_step
    from phiseg_tpu_torch.parallel import shard_array, shard_train_step

    f64 = cfg.compute_dtype == "float64"
    state = create_train_state(cfg, device)
    if f64:
        state.model.double()
    state.model.load_state_dict(init)
    step = make_train_step(cfg, use_fused_ce=not f64, mesh=mesh)
    if mesh is not None:
        step, state = shard_train_step(step, state, mesh)
        x, s, eps = shard_array(x, mesh), shard_array(s, mesh), [shard_array(e, mesh) for e in eps]
    wide = torch.float64 if f64 else x.dtype
    losses = step(state, x.to(device=device, dtype=wide), s.to(device),
                  eps=[e.to(device=device, dtype=wide) for e in eps])
    return ({k: float(v) for k, v in losses.items()},
            {n: p.grad.cpu() for n, p in state.model.named_parameters()},
            {n: b.cpu() for n, b in state.model.named_buffers() if "running" in n})


def _dp_rank(p):
    """One rank of phase 5 (runs in a spawned process, gloo on cuda:0)."""
    import torch

    from phiseg_tpu_torch.data import get_dataset
    from phiseg_tpu_torch.engine.config import ExperimentConfig
    from phiseg_tpu_torch.engine.train import build_model, make_sample_fn
    from phiseg_tpu_torch.engine.trainer import Trainer
    from phiseg_tpu_torch.ops import fused_residual_ce as frce
    from phiseg_tpu_torch.parallel import make_mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(device=torch.device("cuda", 0))
    dev = mesh.device
    out = {"rank": mesh.rank, "backend": torch.distributed.get_backend()}

    # one f32 step and one f64 step from the saved state, injected noise, no
    # augmentation
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    out["losses"], out["grads"], out["running"] = _step_once(
        ExperimentConfig.from_json(p["cfg32"]), p["init"], p["x"], p["s"], p["eps"], dev, mesh)
    out["f32_step_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["f64"] = _step_once(ExperimentConfig.from_json(p["cfg64"]), p["init"], p["x"], p["s"],
                            p["eps"], dev, mesh)
    out["f64_step_s"] = time.perf_counter() - t0

    # the sharded sampler, f32, the saved weights
    model = build_model(ExperimentConfig.from_json(p["cfg32"]), dev)
    model.load_state_dict(p["init"])
    g = torch.Generator(device=dev).manual_seed(p["sample_seed"])
    out["sharded"] = make_sample_fn(model, SAMPLES, mesh=mesh)(p["sample_x"].to(dev), g).cpu()
    torch.backends.cudnn.deterministic = False
    del model
    torch.cuda.empty_cache()

    # K3 at the main-path shape: each rank holds its half of the global batch
    logits, s_oh = _case(5, 12, 128, 2, torch.float32, seed=0)
    lg = logits[:, mesh.rank * 6:(mesh.rank + 1) * 6].contiguous()
    so = s_oh[mesh.rank * 6:(mesh.rank + 1) * 6].contiguous()
    with torch.no_grad():
        k3 = frce.fused_residual_ce_dp(lg, so, mesh)
        ref = frce.residual_ce_plain(logits, s_oh)
        out["k3_err"] = (k3 - ref).abs().max().item()
        out["k3_rel"] = ((k3 - ref).abs() / ref.abs()).max().item()
        out["k3_ms"] = cuda_ms(lambda: frce.fused_residual_ce_dp(lg, so, mesh))
        out["k3_plain_ms"] = cuda_ms(lambda: mesh.mean(frce.residual_ce_plain(lg, so)))
    out["k3_shape"] = tuple(lg.shape)

    # DP_STEPS bf16 steps with augmentation through the Trainer
    cfg = ExperimentConfig.from_json(p["cfg"])
    data = get_dataset(cfg)
    frce.reset_launch_counts()
    trainer = Trainer(cfg, log_dir=p["log_dir"], mesh=mesh)
    trainer.train(data)
    torch.cuda.synchronize()
    out["launches"] = dict(frce.LAUNCHES)
    out["state"] = {k: v.cpu() for k, v in trainer.state.model.state_dict().items()}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def _rel_max(a, b):
    """Worst over tensors of max|a - b| / max|b|, and the tensor."""
    worst = max(((float((a[n] - b[n]).abs().max()) / (float(b[n].abs().max()) + 1e-30), n)
                 for n in b), key=lambda t: t[0])
    return worst


def phase_dp(cfg):
    import torch

    from phiseg_tpu_torch.data import get_dataset
    from phiseg_tpu_torch.engine.train import build_model, create_train_state, make_sample_fn
    from phiseg_tpu_torch.parallel import spawn_ranks

    cfg32 = cfg.replace(compute_dtype="float32")
    cfg64 = cfg.replace(compute_dtype="float64")
    data = get_dataset(cfg)
    x, s = data.train.next_batch(cfg.batch_size)
    x, s = torch.from_numpy(x), torch.from_numpy(s.astype("uint8"))
    eps = _latent_eps(cfg32, cfg.batch_size, torch.Generator().manual_seed(7))
    init = {k: v.cpu() for k, v in create_train_state(cfg32, torch.device("cuda")).model
            .state_dict().items()}
    sample_x = x[:2].clone()

    cuda = torch.device("cuda")
    torch.backends.cudnn.deterministic = True
    try:
        one = _step_once(cfg32, init, x, s, eps, cuda)
        again = _step_once(cfg32, init, x, s, eps, cuda)
        # the images one f32 ulp up: how far round-off alone moves the step
        nudged = _step_once(cfg32, init, torch.nextafter(x, torch.full_like(x, math.inf)),
                            s, eps, cuda)
        # the same step in f64: what the f32 steps approximate
        one64 = _step_once(cfg64, init, x, s, eps, cuda)
        torch.cuda.empty_cache()
        model = build_model(cfg32, torch.device("cuda"))
        model.load_state_dict(init)
        g = torch.Generator(device="cuda").manual_seed(11)
        unsharded = make_sample_fn(model, SAMPLES)(sample_x.cuda(), g).cpu()
        del model
    finally:
        torch.backends.cudnn.deterministic = False
    log_dir = os.path.join(OUT_DIR, "dp", "log")
    dcfg = cfg.replace(num_iter=DP_STEPS, tensorboard_update_frequency=1)
    say(f"dp: {DP_WORLD} gloo ranks on cuda:0, {EXPERIMENT} at full width, global batch "
        f"{cfg.batch_size} ({cfg.batch_size // DP_WORLD} per rank)")
    t0 = time.perf_counter()
    payload = dict(cfg32=cfg32.to_json(), cfg64=cfg64.to_json(), cfg=dcfg.to_json(), init=init,
                   x=x, s=s, eps=eps, sample_x=sample_x, sample_seed=11, log_dir=log_dir)
    try:
        outs = spawn_ranks(_dp_rank, DP_WORLD, (payload,), backend="gloo", timeout=RANK_TIMEOUT)
    except (RuntimeError, TimeoutError) as e:
        fail(f"data-parallel ranks: {e}")
    say(f"dp: ranks done in {time.perf_counter() - t0:.2f} s (spawn, imports and all phases); "
        f"backend {outs[0]['backend']}; f32 step {outs[0]['f32_step_s']:.3f} s, f64 step "
        f"{outs[0]['f64_step_s']:.3f} s on rank 0; peak {max(o['peak_gib'] for o in outs):.3f} "
        f"GiB per rank")

    # The 2-rank step vs the 1-rank step in f64, tensor by tensor: the two
    # are one function summed in another order, so they agree to f64
    # round-off, amplified as far as the images-one-ulp-up run shows f32's
    # is (~3e5), unless the data-parallel path is wrong.
    ld64, gr64, rs64 = one64
    for o in outs:
        if set(o["f64"][0]) != set(ld64):
            fail(f"rank {o['rank']} f64 loss keys {sorted(o['f64'][0])}")
    loss64 = max(abs(o["f64"][0][k] - ld64[k]) / abs(ld64[k]) for o in outs for k in ld64)
    grad64, grad64_at = max(_rel_max(o["f64"][1], gr64) for o in outs)
    run64, run64_at = max(_rel_max(o["f64"][2], rs64) for o in outs)
    dtypes = {str(t.dtype) for o in outs for t in o["f64"][1].values()}
    say(f"dp f64 step, 2 ranks vs 1 rank (per tensor, max|diff| / max|1 rank|; tol 1e-6): "
        f"worst loss rel {loss64:.3e}; gradients worst {grad64:.3e} at {grad64_at}; BN running "
        f"stats worst {run64:.3e} at {run64_at}; gradient dtypes {sorted(dtypes)}")
    if not (loss64 <= 1e-6 and grad64 <= 1e-6 and run64 <= 1e-6) or dtypes != {"torch.float64"}:
        fail("the 2-rank f64 step disagrees with the 1-rank f64 step")
    # How far each f32 step is from the f64 one: 1 rank (F.batch_norm) and
    # 2 ranks (sync-BN, E[x^2] - E[x]^2).
    for k, g in (("1 rank", one[1]), ("2 ranks", outs[0]["grads"])):
        worst, at = _rel_max(g, gr64)
        say(f"dp f32 gradients, {k}, vs the f64 1-rank step: rel L2 {_rel_l2(g, gr64):.3e}, "
            f"worst tensor {worst:.3e} at {at}")

    # The 2-rank step vs the 1-rank step on the same global batch in f32.
    # The gradients are held by their relative L2 over all parameters: at
    # init (KL ~1e5, gradients ~1e6) f32 round-off alone moves single tensors
    # by more than 1e-3 of their largest entry, which the run with the images
    # one ulp up shows and the f64 comparison above bounds; per-tensor
    # figures are printed beside it.
    (ld1, gr1, rs1), (ld1b, gr1b, rs1b), (_, gr1u, _) = one, again, nudged
    spread_loss = max(abs(ld1b[k] - ld1[k]) / abs(ld1[k]) for k in ld1)
    spread_l2, ulp_l2 = _rel_l2(gr1b, gr1), _rel_l2(gr1u, gr1)
    ulp_worst, ulp_at = _rel_max(gr1u, gr1)
    spread_run, _ = _rel_max(rs1b, rs1)
    tol_loss, tol_grad, tol_run = max(1e-4, spread_loss), max(1e-3, spread_l2), max(1e-4, spread_run)
    for o in outs:
        if set(o["losses"]) != set(ld1):
            fail(f"rank {o['rank']} loss keys {sorted(o['losses'])}")
    worst_loss = max(abs(o["losses"][k] - ld1[k]) / abs(ld1[k]) for o in outs for k in ld1)
    l2 = max(_rel_l2(o["grads"], gr1) for o in outs)
    worst_grad, grad_at = max(_rel_max(o["grads"], gr1) for o in outs)
    worst_run, run_at = max(_rel_max(o["running"], rs1) for o in outs)
    say(f"dp f32 step, 2 ranks vs 1 rank: worst loss rel {worst_loss:.3e} (tol {tol_loss:.1e}: "
        f"{'1e-4' if tol_loss == 1e-4 else '1-rank spread'}; 1-rank vs 1-rank {spread_loss:.3e}); "
        f"gradients before the optimiser, all-parameter rel L2 {l2:.3e} (tol {tol_grad:.1e}: "
        f"{'1e-3' if tol_grad == 1e-3 else '1-rank spread'}; 1-rank vs 1-rank {spread_l2:.3e}, "
        f"images one ulp up {ulp_l2:.3e}); worst per-tensor max-rel {worst_grad:.3e} at {grad_at} "
        f"(images one ulp up: {ulp_worst:.3e} at {ulp_at}); BN running stats worst "
        f"{worst_run:.3e} at {run_at} (tol {tol_run:.1e}; spread {spread_run:.3e})")
    say(f"dp f32 losses, 2 ranks: {json.dumps(outs[0]['losses'], sort_keys=True)}")
    if not (worst_loss <= tol_loss and l2 <= tol_grad and worst_run <= tol_run):
        fail("the 2-rank step disagrees with the 1-rank step")
    if not all(torch.equal(outs[0]["grads"][n], outs[1]["grads"][n]) for n in gr1):
        fail("the ranks' averaged gradients differ")

    # the sharded sampler vs the unsharded one
    diffs = [float((o["sharded"] - unsharded).abs().max()) for o in outs]
    say(f"dp sampler: {SAMPLES} samples of B=2 in f32, 2-rank sharded vs unsharded, same seed: "
        f"max abs prob diff {max(diffs):.3e} (tol 1e-4: a rank decodes {SAMPLES} rows, the "
        f"unsharded sampler {2 * SAMPLES}, and cuDNN may pick another algorithm); ranks "
        f"bitwise equal {torch.equal(outs[0]['sharded'], outs[1]['sharded'])}")
    if max(diffs) > 1e-4 or not torch.equal(outs[0]["sharded"], outs[1]["sharded"]):
        fail("the sharded sampler differs from the unsharded one")

    # K3
    k3_err, k3_rel = max(o["k3_err"] for o in outs), max(o["k3_rel"] for o in outs)
    say(f"K3 at L5 B12 (6 per rank) 128x128 C2 f32: vs the plain global value max abs err "
        f"{k3_err:.3e}, rel {k3_rel:.3e} (tol rel {TOLERANCE['float32'][0]:g}, K1's); "
        f"per call incl. host issue and "
        f"the gloo all_reduce {outs[0]['k3_ms']:.4f} ms vs plain + all_reduce "
        f"{outs[0]['k3_plain_ms']:.4f} ms (CUDA events, median of 50, rank 0)")
    if not k3_rel <= TOLERANCE["float32"][0]:
        fail("K3 disagrees with the plain version")

    # DP_STEPS through the Trainer
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    if [r["step"] for r in recs] != list(range(DP_STEPS)):
        fail(f"dp metrics.jsonl holds steps {[r['step'] for r in recs]}")
    for r in recs:
        if not all(math.isfinite(v) for k, v in r.items() if k.startswith("batch_")):
            fail(f"dp: non-finite losses at step {r['step']}")
    for o in outs:
        for k, n in o["launches"].items():
            if n != DP_STEPS:
                fail(f"dp rank {o['rank']}: {k} launched {n} times in {DP_STEPS} steps")
    a, b = outs[0]["state"], outs[1]["state"]
    unequal = [k for k in a if not torch.equal(a[k], b[k])]
    say(f"dp trainer: {DP_STEPS} bf16 steps with augmentation, losses finite (total "
        f"{recs[0]['batch_total_loss']:.6g} -> {recs[-1]['batch_total_loss']:.6g}); launches per "
        f"rank {[o['launches'] for o in outs]}; rank state_dicts bitwise equal: "
        f"{not unequal} ({len(unequal)} of {len(a)} entries differ)")
    if unequal:
        fail(f"the ranks' states differ after {DP_STEPS} steps: {unequal[:5]}")
    step_ms = [1000.0 * cfg.batch_size / r["images_per_sec"] for r in recs[2:]]
    say(f"dp step time (a correctness run: two processes share one card, gloo through the "
        f"host): median {statistics.median(step_ms):.3f} ms over steps 2..{DP_STEPS - 1}")
    return outs, k3_err


def phase_mesh1():
    from phiseg_tpu_torch.cli.train import main as train_main

    cfg_path = os.path.join(OUT_DIR, "config.json")
    log_dir = os.path.join(OUT_DIR, "mesh1", "log")
    t0 = time.perf_counter()
    try:  # each rank zeroes its launch counts before it trains
        ranks = train_main([cfg_path, "--mesh", "1", "--num-iter", "3", "--log-dir", log_dir],
                           timeout=RANK_TIMEOUT)
    except (RuntimeError, TimeoutError) as e:
        fail(f"--mesh 1: {e}")
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    ok = [r["step"] for r in recs] == [0, 1, 2] and all(
        math.isfinite(v) for r in recs for k, v in r.items() if k.startswith("batch_"))
    steps, launches = [st for st, _ in ranks], [n for _, n in ranks]
    say(f"--mesh 1 (NCCL, one rank on cuda:0) through the CLI: steps {steps}, "
        f"{len(recs)} finite loss records, launches {launches}, "
        f"{time.perf_counter() - t0:.2f} s incl. spawn")
    if steps != [3] or not ok:
        fail("--mesh 1 did not train 3 steps with finite losses")
    for k in ("fused_residual_ce_fwd", "fused_residual_ce_bwd", "fused_residual_ce_dp"):
        if launches[0].get(k) != 3:
            fail(f"--mesh 1: {k} launched {launches[0].get(k)} times in 3 steps")


def phase_sampler(trainer, what: str):
    """The SAMPLES-sample prior sampler on the trained model at B=1 and B=8:
    ms/image of device time and per call, and the peak device memory."""
    import torch

    from phiseg_tpu_torch.data import get_dataset
    from phiseg_tpu_torch.engine.train import make_sample_fn

    cfg = trainer.cfg
    model = trainer.state.model
    data = get_dataset(cfg)
    sample = make_sample_fn(model, SAMPLES)
    res = {}
    for b in (1, 8):
        x = torch.from_numpy(data.train.next_batch(b)[0]).cuda()
        g = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        probs = sample(x, g)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if probs.shape != (SAMPLES, b, *cfg.image_hw, cfg.nlabels) or not torch.isfinite(probs).all():
            fail(f"sampler output {tuple(probs.shape)} or non-finite at B={b}")
        if not torch.allclose(probs.sum(-1), torch.ones((), device="cuda"), atol=1e-5):
            fail("sampler probabilities do not sum to 1")
        # one call per timing: ~700 launches, which the launch queue holds
        dev = device_ms(lambda: sample(x, g), iters=1, warmup=2)
        call = cuda_ms(lambda: sample(x, g), iters=5, warmup=1)
        res[b] = (dev, call, peak)
        say(f"sampler {SAMPLES} samples B={b} {cfg.compute_dtype} ({cfg.experiment_name}: "
            f"R={cfg.resolution_levels} L={cfg.effective_latent_levels} n0={cfg.n0} "
            f"{cfg.image_hw}, {what}): device "
            f"{dev:.3f} ms/call = {dev / b:.3f} ms/image (CUDA events, host kept ahead, 1 call); "
            f"per call incl. host issue {call:.3f} ms = {call / b:.3f} ms/image (median of 5); "
            f"peak device memory {peak:.3f} GiB")
    return res


VAL_FREQ = 10                   # phase 8: validate at steps 10 and 20 ...
VAL_ITERS, RESUME_ITERS = 21, 26  # ... of 21 steps, then resume to 26
VAL_CHECK_BATCH = 4             # phase 9: images of the card-vs-CPU validation
QUANT_SAMPLES, QUANT_BATCH = 100, 8  # phase 10 (and 12's batch)
FAMILY_EXPERIMENTS = ("probunet_synth", "detunet_synth")  # phase 11
TIE = 1e-3  # phase 9: |p1 - p0| under which card and CPU masks may differ
# phase 9: card (K1, cuDNN) vs CPU (plain CE, CPU convolutions), both f32
# with TF32 off: probabilities rel ~1e-6, so masks flip only at near-ties;
# a flipped pixel moves Dice and GED^2 by ~1/(its mask's foreground count).
# The ELBO is mostly KL; the per-level CE, K1's output, is held on its own.
VAL_TOL = {"dice_ged_atol": 2e-3, "sncc_rtol": 1e-3, "elbo_rtol": 1e-4, "ce_rtol": 1e-4}
# phases 9, 11: the least nonzero f32 population std, the square root of
# the least subnormal (1.4e-45): a map whose mean squared deviation rounds
# below that has std 0
F32_LEAST_STD = math.sqrt(2.0 ** -149)
# phase 9: card vs CPU sample probabilities in f64; f64 round-off (1.1e-16)
# amplified as far as the f32 gap shows f32's is (~1e4), with room to spare
F64_GAP = 1e-8


def _validation_k1(cfg, n_images: int) -> int:
    """K1 launches of one validation: the two eval-loss calls, and one per
    ELBO draw for each batch of up to 32 validation images."""
    return 2 + -(-n_images // 32) * cfg.validation_elbo_samples


def _train_with_validations(cfg_path: str, log_dir: str, run=None, iters: int = VAL_ITERS):
    """`iters` steps (VAL_ITERS) through the train CLI, or through `run()`,
    which returns the Trainer it trained, validating every VAL_FREQ:
    the seconds, peak device memory and kernel launches of each validation,
    and the peak of the steps before it, recorded; the steps, validations,
    finite values and the best_* checkpoints of every metric that was finite
    once checked. S_NCC may be undefined (NaN) only on images where
    _undefined_ncc_explained finds the metric's 0/0 in the validation's own
    draws. Returns (trainer, launches, validation records, wall seconds,
    metrics.jsonl records)."""
    import torch

    from phiseg_tpu_torch.cli.train import main as train_main
    from phiseg_tpu_torch.engine import trainer as trainer_mod
    from phiseg_tpu_torch.engine.checkpoint import CheckpointManager
    from phiseg_tpu_torch.ops import fused_residual_ce as frce

    records = []
    orig = trainer_mod.Trainer.do_validation

    def timed(self, data, step, **kw):  # seconds, peak memory and launches of one validation
        torch.cuda.synchronize()
        steps_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        before = dict(frce.LAUNCHES)
        undefined = []  # the batches whose S_NCC came out NaN, with their generator state
        validate = self.validate_fn

        def watched(x, ann, s_sel, gen, *a, **k):
            state = gen.get_state()
            out = validate(x, ann, s_sel, gen, *a, **k)
            if not torch.isfinite(out[2]).all():
                undefined.append((x, ann, gen.device, state, out[2]))
            return out

        self.validate_fn = watched
        t0 = time.perf_counter()
        try:
            scalars = orig(self, data, step, **kw)
            torch.cuda.synchronize()
        finally:
            self.validate_fn = validate
        records.append({"step": step, "seconds": time.perf_counter() - t0,
                        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                        "steps_peak_gib": steps_peak,
                        "launches": {k: frce.LAUNCHES[k] - before[k] for k in before},
                        "scalars": scalars,
                        "ncc_undefined": _undefined_ncc_explained(self.state.model, self.cfg,
                                                                  undefined)})
        torch.cuda.reset_peak_memory_stats()  # the next record's steps_peak_gib: steps only
        return scalars

    trainer_mod.Trainer.do_validation = timed
    try:
        frce.reset_launch_counts()
        t0 = time.perf_counter()
        trainer = run() if run is not None else \
            train_main([cfg_path, "--log-dir", log_dir, "--num-iter", str(iters)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(frce.LAUNCHES)
    finally:
        trainer_mod.Trainer.do_validation = orig

    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    val_recs = [r for r in recs if "validation_GED" in r]
    if [r["step"] for r in recs if "batch_total_loss" in r] != list(range(iters)):
        fail(f"metrics.jsonl holds train steps {[r['step'] for r in recs]}")
    if [r["step"] for r in val_recs] != list(range(VAL_FREQ, iters, VAL_FREQ)):
        fail(f"validations at steps {[r['step'] for r in val_recs]}")
    explained = {r["step"] for r in records if r["ncc_undefined"]}
    for r in recs:
        bad = [k for k, v in r.items() if isinstance(v, float) and not math.isfinite(v)
               and not (k == "validation_NCC" and r["step"] in explained)]
        if bad:
            fail(f"non-finite values at step {r['step']}: {bad}")
    metric = {"dice": "validation_dice_mean_score", "loss": "validation_neg_elbo",
              "ged": "validation_GED", "ncc": "validation_NCC"}
    for tag in ["latest"] + [f"best_{m}" for m, k in metric.items()
                             if any(math.isfinite(r[k]) for r in val_recs)]:
        if not CheckpointManager(log_dir).has_checkpoint(tag):
            fail(f"no {tag} checkpoint in {log_dir} after {iters} steps")
    return trainer, launches, records, wall, recs


def _say_validations(records, per_val: int, what: str = "") -> None:
    """Print each validation's time, memory, launches and scalars; K1 must
    have launched per_val times in each, K2 not at all."""
    for r in records:
        sc = r["scalars"]
        say(f"{what}validation at step {r['step']}: {r['seconds']:.3f} s, peak device memory "
            f"{r['peak_gib']:.3f} GiB, K1 {r['launches']['fused_residual_ce_fwd']} K2 "
            f"{r['launches']['fused_residual_ce_bwd']}; GED^2 {sc['validation_GED']:.6g} "
            f"S_NCC {sc['validation_NCC']:.6g} Dice {sc['validation_dice_mean_score']:.6g} "
            f"(fg {sc['validation_dice_lbl_1']:.6g}) -ELBO {sc['validation_neg_elbo']:.6g}; "
            f"S_NCC undefined (maps with std 0, drawn again) on {r['ncc_undefined']} images")
        if r["launches"]["fused_residual_ce_fwd"] != per_val or r["launches"]["fused_residual_ce_bwd"]:
            fail(f"one validation launched {r['launches']}, not K1 x {per_val}")


def phase_validate():
    """Train with validation through the CLI, keep the checkpoints, resume."""
    import glob

    import torch

    from phiseg_tpu_torch.cli.train import main as train_main
    from phiseg_tpu_torch.engine import trainer as trainer_mod
    from phiseg_tpu_torch.engine.checkpoint import CheckpointManager
    from phiseg_tpu_torch.experiments import get_experiment
    from phiseg_tpu_torch.ops import fused_residual_ce as frce

    cfg = get_experiment(EXPERIMENT).replace(validation_frequency=VAL_FREQ,
                                             tensorboard_update_frequency=1)
    root = os.path.join(OUT_DIR, "validate")
    os.makedirs(root)
    cfg_path, log_dir = os.path.join(root, "config.json"), os.path.join(root, "log")
    cfg.save(cfg_path)
    n_images = min(cfg.synth_n_val, int(cfg.num_validation_images))
    per_val = _validation_k1(cfg, n_images)
    say(f"validate: {EXPERIMENT} full width, batch {cfg.batch_size}, {cfg.compute_dtype}, "
        f"validation every {VAL_FREQ} steps over {n_images} images, "
        f"{cfg.validation_samples} samples, {cfg.validation_elbo_samples} ELBO draws; "
        f"{VAL_ITERS} steps, then resumed to {RESUME_ITERS}")

    first, launches, records, wall, recs = _train_with_validations(cfg_path, log_dir)
    names = sorted(os.path.basename(p) for p in glob.glob(os.path.join(log_dir, "model*.pt")))
    say(f"validate: checkpoints {names}; best_metrics.json "
        f"{open(os.path.join(log_dir, 'best_metrics.json')).read()}")
    if f"model.ckpt-{VAL_ITERS}.pt" not in names:
        fail("the final state was not saved as latest")
    by_step = {}
    for p in glob.glob(os.path.join(log_dir, "model_best_*.pt")):
        by_step.setdefault(p.rsplit("-", 1)[1], []).append(os.stat(p).st_ino)
    say(f"validate: best_* files by step -> distinct inodes "
        f"{ {k: len(set(v)) for k, v in by_step.items()} } of files "
        f"{ {k: len(v) for k, v in by_step.items()} }")
    if any(len(set(v)) != 1 for v in by_step.values()) or max(map(len, by_step.values())) < 2:
        fail("tags saved from one snapshot at one step do not share an inode")

    want_k1 = VAL_ITERS + 2 * per_val
    say(f"validate: K1 launches {launches['fused_residual_ce_fwd']} = {VAL_ITERS} steps + 2 "
        f"validations x (2 eval-loss calls + ceil({n_images}/32) x "
        f"{cfg.validation_elbo_samples} ELBO draws) = {want_k1}; K2 "
        f"{launches['fused_residual_ce_bwd']} (one a step)")
    if launches["fused_residual_ce_fwd"] != want_k1 or \
            launches["fused_residual_ce_bwd"] != VAL_ITERS or launches["fused_residual_ce_dp"]:
        fail(f"launches {launches}")
    _say_validations(records, per_val)
    say(f"validate: {VAL_ITERS} steps with 2 validations took {wall:.2f} s of wall time")

    # the resumed state equals the saved one, and the first run's live state,
    # bit for bit: model (BN statistics included), Adam, step, generator
    resumed = trainer_mod.Trainer(cfg, log_dir=log_dir)
    saved, _ = CheckpointManager(log_dir).read("latest")
    live = {"model": first.state.model.state_dict(), "optimizer": first.state.optimizer.state_dict()}
    back = {"model": resumed.state.model.state_dict(),
            "optimizer": resumed.state.optimizer.state_dict()}
    mismatched = []
    for name, ref in (("saved", saved), ("live", live)):
        for k, v in ref["model"].items():
            if not torch.equal(v.cpu(), back["model"][k].cpu()):
                mismatched.append((name, "model", k))
        for i, st in ref["optimizer"]["state"].items():
            for k, v in st.items():
                if not torch.equal(v.cpu(), back["optimizer"]["state"][i][k].cpu()):
                    mismatched.append((name, "adam", i, k))
    gen_ok = torch.equal(resumed.generator.get_state(), first.generator.get_state()) and \
        torch.equal(resumed.generator.get_state(), saved["generator"])
    n_adam = sum(len(st) for st in saved["optimizer"]["state"].values())
    say(f"resume: {len(saved['model'])} model tensors and {n_adam} Adam tensors; bitwise "
        f"mismatches vs the file and vs the first run's live state: {len(mismatched)}; step "
        f"{resumed.state.step} (file {saved['step']}); generator equal: {gen_ok}")
    if mismatched or not gen_ok or resumed.init_step != VAL_ITERS or saved["step"] != VAL_ITERS:
        fail(f"the resumed state differs from the saved one: {mismatched[:5]}")
    del resumed

    frce.reset_launch_counts()
    second = train_main([cfg_path, "--log-dir", log_dir, "--num-iter", str(RESUME_ITERS)])
    launches2 = dict(frce.LAUNCHES)
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f][len(recs):]
    say(f"resume through the CLI: started at step {second.init_step}, logged steps {steps}, "
        f"ended at {second.state.step}; launches {launches2}")
    if second.init_step != VAL_ITERS or steps != list(range(VAL_ITERS, RESUME_ITERS)) or \
            second.state.step != RESUME_ITERS:
        fail("the second run did not resume at the saved step")
    n_steps = RESUME_ITERS - VAL_ITERS
    if launches2["fused_residual_ce_fwd"] != n_steps or launches2["fused_residual_ce_bwd"] != n_steps:
        fail(f"the resumed run launched {launches2} in {n_steps} steps")
    return {"log_dir": log_dir, "trainer": second, "launches": launches, "per_val": per_val,
            "records": records}


def _val_images(data, b: int):
    """The first b validation images (B,H,W,1) f32, their annotations
    (B,M,H,W) int64 and one annotation each, cycling over the annotators,
    on the CPU."""
    import numpy as np
    import torch

    x = torch.from_numpy(data.validation.images[:b].astype(np.float32)[..., None])
    ann = torch.from_numpy(np.transpose(data.validation.labels[:b], (0, 3, 1, 2)).astype(np.int64))
    return x, ann, ann[torch.arange(b), torch.arange(b) % ann.shape[1]]


def _k1_on_the_validation_path(cfg, model, data):
    """Every K1 call of one make_validation_fn over a full batch of val
    images and of one make_eval_loss_fn call at the train batch, in the
    config's compute dtype on a trained model, against residual_ce_plain of
    the same card tensors, level by level. Returns the largest relative
    error."""
    import torch

    from phiseg_tpu_torch.engine import objective as objective_mod
    from phiseg_tpu_torch.engine.train import make_eval_loss_fn
    from phiseg_tpu_torch.engine.validation import make_validation_fn
    from phiseg_tpu_torch.ops import fused_residual_ce as frce

    b = min(32, data.validation.images.shape[0])
    x, ann, s_sel = (t.cuda() for t in _val_images(data, b))
    calls, real = [], objective_mod.fused_residual_ce

    def record(levels, s_oh):  # the objective's K1 call, its inputs kept
        out = real(levels, s_oh)
        calls.append((list(levels), s_oh, out))
        return out

    g = torch.Generator(device="cuda").manual_seed(13)
    objective_mod.fused_residual_ce = record
    try:
        make_validation_fn(model, cfg)(x, ann, s_sel, g)
        n_elbo = len(calls)
        make_eval_loss_fn(model, cfg)(x[:cfg.batch_size], s_sel[:cfg.batch_size], g)
    finally:
        objective_mod.fused_residual_ce = real
    if n_elbo != cfg.validation_elbo_samples or len(calls) != n_elbo + 1:
        fail(f"K1 ran {n_elbo} + {len(calls) - n_elbo} times on the validation path")
    # the likelihood hands out f32 levels under bf16 compute
    rtol = min(TOLERANCE[str(t.dtype).split(".")[-1]][0] for levels, _, _ in calls for t in levels)
    worst, first = 0.0, ([], [])
    for levels, s_oh, out in calls:
        ref = frce.residual_ce_plain(levels, s_oh)
        worst = max(worst, ((out - ref).abs() / ref.abs().clamp_min(1e-30)).max().item())
        first = first if first[0] else (out.tolist(), ref.tolist())
    shapes = sorted({(tuple(t.shape), str(t.dtype).split(".")[-1])
                     for levels, _, _ in calls for t in levels})
    say(f"{cfg.experiment_name}: K1 on the validation path ({cfg.compute_dtype} compute, eval BN, "
        f"no autograd): {n_elbo} calls of make_validation_fn at {b} images + "
        f"{len(calls) - n_elbo} of make_eval_loss_fn at {cfg.batch_size}, levels {shapes}; K1 vs "
        f"plain CE on the same card tensors, worst per-level rel {worst:.3e} (tol {rtol:g}, phase "
        f"2's for the levels' dtype); first ELBO draw K1 {[round(v, 3) for v in first[0]]} plain "
        f"{[round(v, 3) for v in first[1]]}")
    if not worst <= rtol:
        fail(f"{cfg.experiment_name}: K1 disagrees with the plain CE on the validation path")
    return worst


def _saturated(probs) -> float:
    """The share of the probabilities that are exactly 0 or 1."""
    return ((probs == 0) | (probs == 1)).float().mean().item()


def _validation_card_vs_cpu(cfg, trained, data):
    """make_validation_fn, make_eval_loss_fn and make_sample_fn of one set
    of trained weights (BN running statistics included) on the card and on
    the CPU: VAL_CHECK_BATCH val images, the same noise, both in f32 with
    TF32 off. The masks may differ only at near-ties; Dice, GED^2, S_NCC
    (undefined on the same images; where its maps agree, and on identical
    inputs), the ELBO and the per-level CE agree within VAL_TOL. Returns the images, the sampler's noise, both devices'
    sample probabilities and their gap."""
    import torch

    from phiseg_tpu_torch.engine.train import build_model, make_eval_loss_fn, make_sample_fn
    from phiseg_tpu_torch.engine.validation import make_validation_fn
    from phiseg_tpu_torch.metrics import population_std, variance_ncc_dist, variance_ncc_maps
    from phiseg_tpu_torch.nn.losses import one_hot
    from phiseg_tpu_torch.ops import fused_residual_ce as frce

    cfg = cfg.replace(compute_dtype="float32")
    name, b = cfg.experiment_name, VAL_CHECK_BATCH
    x, ann, s_sel = _val_images(data, b)
    models = {dev: build_model(cfg, device=dev) for dev in ("cuda", "cpu")}
    for m in models.values():
        m.load_state_dict(trained)
    g = torch.Generator().manual_seed(11)
    shapes = models["cpu"].latent_shapes(b)
    eps_s = [torch.randn((cfg.validation_samples, *sh), generator=g) for sh in shapes]
    eps_e = [torch.randn((cfg.validation_elbo_samples, *sh), generator=g) for sh in shapes]
    out, probs, ce = {}, {}, {}
    for dev, m in models.items():
        t0 = time.perf_counter()
        before = frce.LAUNCHES["fused_residual_ce_fwd"]
        on = [t.to(dev) for t in (x, ann, s_sel)]
        res = make_validation_fn(m, cfg)(*on, eps_samples=[e.to(dev) for e in eps_s],
                                         eps_elbo=[e.to(dev) for e in eps_e])
        out[dev] = [t.cpu() for t in res]
        losses = make_eval_loss_fn(m, cfg)(on[0], on[2], eps=[e[0].to(dev) for e in eps_e])
        ce[dev] = {k: float(v) for k, v in losses.items() if k.startswith("residual_multinoulli")}
        probs[dev] = make_sample_fn(m, cfg.validation_samples)(
            on[0], eps=[e.to(dev) for e in eps_s]).cpu()
        say(f"{name} metrics on {dev}: {time.perf_counter() - t0:.2f} s incl. a second sampling; "
            f"K1 launches {frce.LAUNCHES['fused_residual_ce_fwd'] - before}")
    p_rel = ((probs["cuda"] - probs["cpu"]).abs().max() / probs["cpu"].abs().max()).item()
    diff = probs["cuda"].argmax(-1) != probs["cpu"].argmax(-1)
    margin = (probs["cpu"][..., 1] - probs["cpu"][..., 0]).abs()
    n_diff, worst_margin = int(diff.sum()), float(margin[diff].max()) if diff.any() else 0.0
    (d_c, g_c, n_c, e_c), (d_p, g_p, n_p, e_p) = out["cuda"], out["cpu"]
    # S_NCC is 0/0 where a map does not spread: that must happen on the
    # same images on both devices. Its two maps (E_ss, E_sy) from each
    # device's draws are compared first: where they agree within the
    # tolerance (relative L2 of the centred maps), so does S_NCC; where a
    # map's spread is made of softmax tails that round-off moves (a
    # saturated model), its inputs already differ, and the metric is held on
    # identical inputs instead, the card's draws on both devices.
    gt = one_hot(ann, cfg.nlabels)
    maps, spread = {}, {}
    for dev in probs:
        e_ss, e_sy = variance_ncc_maps(probs[dev].transpose(0, 1), gt)
        m = torch.cat([e_ss.unsqueeze(1), e_sy], 1).flatten(2)  # (B,1+M,HW)
        maps[dev] = m - m.mean(-1, keepdim=True)
        spread[dev] = population_std(m).squeeze(-1).amin(-1)  # (B,) the least-spread map's
    map_gap = ((maps["cuda"] - maps["cpu"]).norm(dim=-1)
               / maps["cpu"].norm(dim=-1)).nan_to_num(math.inf).amax(-1)  # (B,)
    # the card's own arithmetic on its draws: its maps and their least std
    e_ss, e_sy = variance_ncc_maps(probs["cuda"].transpose(0, 1).cuda(), gt.cuda())
    spread_card = population_std(torch.cat([e_ss.unsqueeze(1), e_sy], 1).flatten(2)
                                 ).squeeze(-1).amin(-1).cpu()
    undef = {dev: ~torch.isfinite(n) for dev, n in (("cuda", n_c), ("cpu", n_p))}
    # A saturated softmax can leave a map whose deviations all square to 0
    # in the CPU's f32 (std exactly 0: S_NCC undefined) while the card's
    # reduction order leaves a round-off spread (S_NCC defined, and
    # meaningless). An image may be undefined on one device only if both
    # devices' draws give such a map, a std of exactly 0 in the metric's own
    # f32 on the CPU; the least nonzero std there is F32_LEAST_STD.
    flip = undef["cuda"] != undef["cpu"]
    bad_flip = flip & ~((spread["cuda"] == 0) & (spread["cpu"] == 0))
    held = ~undef["cpu"] & (map_gap <= VAL_TOL["sncc_rtol"])
    p_c = probs["cuda"].transpose(0, 1)
    same_in = {"cuda": variance_ncc_dist(p_c.cuda(), gt.cuda()).cpu(),
               "cpu": variance_ncc_dist(p_c, gt)}
    fin = torch.isfinite(same_in["cpu"]) & torch.isfinite(same_in["cuda"])
    flip_same = torch.isfinite(same_in["cpu"]) != torch.isfinite(same_in["cuda"])
    bad_flip_same = flip_same & ~(spread["cuda"] == 0)  # the card's draws' maps
    defined = ~undef["cuda"] & ~undef["cpu"]
    least_defined = spread["cpu"][defined].min().item() if defined.any() else math.inf
    errs = {"dice": (d_c - d_p).abs().max().item(), "ged": (g_c - g_p).abs().max().item(),
            "sncc": ((n_c[held] - n_p[held]).abs() / n_p[held].abs()).max().item()
            if held.any() else 0.0,
            "sncc_same_in": ((same_in["cuda"][fin] - same_in["cpu"][fin]).abs()
                             / same_in["cpu"][fin].abs()).max().item() if fin.any() else 0.0,
            "elbo": abs(float(e_c) - float(e_p)) / abs(float(e_p)),
            "ce": max(abs(ce["cuda"][k] - v) / abs(v) for k, v in ce["cpu"].items())}
    say(f"{name} metrics card vs CPU ({b} val images, {cfg.validation_samples} samples, "
        f"{cfg.validation_elbo_samples} ELBO draws, f32, TF32 off): probabilities max rel "
        f"{p_rel:.3e}, exactly 0 or 1 {_saturated(probs['cuda']):.4%} card, "
        f"{_saturated(probs['cpu']):.4%} CPU; mask pixels that differ {n_diff} of {diff.numel()} "
        f"(largest |p1-p0| among them {worst_margin:.3e}, near-tie below {TIE:g}); Dice "
        f"max|diff| {errs['dice']:.3e}, GED^2 max|diff| {errs['ged']:.3e} (atol "
        f"{VAL_TOL['dice_ged_atol']:g}), S_NCC undefined on images {undef['cuda'].tolist()} card, "
        f"{undef['cpu'].tolist()} CPU (least map spread card "
        f"{[f'{v:.1e}' for v in spread['cuda'].tolist()]}, CPU "
        f"{[f'{v:.1e}' for v in spread['cpu'].tolist()]}, both by the CPU's f32; the card's "
        f"own on its draws {[f'{v:.1e}' for v in spread_card.tolist()]}; least on an image "
        f"defined on both devices {least_defined:.2e}, least nonzero possible "
        f"{F32_LEAST_STD:.2e}; undefined on one device only where both are exactly 0: "
        f"{not bad_flip.any()}); its maps card vs "
        f"CPU, relative L2 per image "
        f"{[f'{v:.2e}' for v in map_gap.tolist()]}; S_NCC max rel {errs['sncc']:.3e} on the "
        f"{int(held.sum())} images whose maps agree, on the card's draws card vs CPU "
        f"{errs['sncc_same_in']:.3e} (undefined alike {not flip_same.any()}, else below the "
        f"spread {not bad_flip_same.any()}) (rtol "
        f"{VAL_TOL['sncc_rtol']:g}); card {n_c.tolist()} cpu {n_p.tolist()}; ELBO rel "
        f"{errs['elbo']:.3e} (rtol {VAL_TOL['elbo_rtol']:g}); "
        f"Dice card {d_c.mean().item():.6g} cpu {d_p.mean().item():.6g}; GED^2 card "
        f"{g_c.tolist()} cpu {g_p.tolist()}")
    say(f"{name} eval losses card (K1) vs CPU (plain CE), f32, first ELBO draw's noise: per-level "
        f"CE max rel {errs['ce']:.3e} (rtol {VAL_TOL['ce_rtol']:g}); card "
        f"{[round(v, 3) for v in ce['cuda'].values()]} cpu {[round(v, 3) for v in ce['cpu'].values()]}")
    if worst_margin >= TIE or errs["dice"] > VAL_TOL["dice_ged_atol"] or \
            errs["ged"] > VAL_TOL["dice_ged_atol"] or not errs["sncc"] <= VAL_TOL["sncc_rtol"] or \
            not errs["sncc_same_in"] <= VAL_TOL["sncc_rtol"] or \
            bad_flip.any() or bad_flip_same.any() or \
            not errs["elbo"] <= VAL_TOL["elbo_rtol"] or not errs["ce"] <= VAL_TOL["ce_rtol"]:
        fail(f"{name}: validation metrics on the card disagree with the CPU's")
    return x, eps_s, probs, p_rel


def phase_metrics(val):
    """K1 on the validation path against the plain CE; make_validation_fn
    and make_eval_loss_fn on the card and on the CPU, one batch, the same
    noise, both in f32, then the sampler in f64; then GED^2's exactness
    with TF32 and autocast on."""
    import torch

    from phiseg_tpu_torch.data import get_dataset
    from phiseg_tpu_torch.engine.train import build_model, make_sample_fn
    from phiseg_tpu_torch.metrics import ged_terms

    cfg, model = val["trainer"].cfg, val["trainer"].state.model
    data = get_dataset(cfg)
    k1_val_err = _k1_on_the_validation_path(cfg, model, data)
    trained = model.state_dict()
    x, eps_s, probs, p_rel = _validation_card_vs_cpu(cfg, trained, data)
    b = x.shape[0]

    # The same draws in f64 on both devices (the sampler runs no CE, so the
    # kernels' f32/bf16 inputs do not bind): if the card's arithmetic is
    # right, the f32 gap is f32 round-off amplified by the model, and the
    # f64 gap is that much f64 round-off.
    cfg64 = cfg.replace(compute_dtype="float64")
    probs64 = {}
    for dev in ("cuda", "cpu"):
        m = build_model(cfg64, device=dev).double()
        m.load_state_dict(trained)
        probs64[dev] = make_sample_fn(m, cfg.validation_samples)(
            x.to(dev, torch.float64), eps=[e.to(dev, torch.float64) for e in eps_s]).cpu()
        del m
    p_rel64 = ((probs64["cuda"] - probs64["cpu"]).abs().max() / probs64["cpu"].abs().max()).item()
    f32_vs_64 = (probs["cpu"].double() - probs64["cpu"]).abs().max().item()
    say(f"sample probabilities card vs CPU, same weights and noise ({b} val images x "
        f"{cfg.validation_samples} samples): max|diff|/max {p_rel:.3e} in f32 (TF32 off), "
        f"{p_rel64:.3e} in f64 (tol {F64_GAP:g}); the CPU's f32 vs its f64 {f32_vs_64:.3e}")
    if not p_rel64 <= F64_GAP:
        fail("the card's f64 sample probabilities differ from the CPU's beyond round-off")

    # GED^2 on fixed 128x128 masks: exact counts whatever TF32 and autocast say
    gm = torch.Generator(device="cuda").manual_seed(12)
    samples = (torch.rand((8, 16, *cfg.image_hw), generator=gm, device="cuda") > 0.3).long()
    gts = (torch.rand((8, 4, *cfg.image_hw), generator=gm, device="cuda") > 0.3).long()
    ref = torch.stack(ged_terms(samples, gts, 1, (1,)))
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32 = torch.stack(ged_terms(samples, gts, 1, (1,)))
        with torch.autocast("cuda", dtype=torch.bfloat16):
            bf16 = torch.stack(ged_terms(samples, gts, 1, (1,)))
            # the intersections as a plain product would count them
            a, bb = samples.flatten(-2).float(), gts.flatten(-2).float().transpose(-1, -2)
            naive_bf16 = torch.matmul(a, bb)
        naive_tf32 = torch.matmul(a, bb)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    exact = torch.matmul(a.double(), bb.double())
    say(f"GED^2 on fixed masks (8 images, 16 samples, 4 annotators, 128x128, ~11469 px a mask): "
        f"TF32 on equal to off: {torch.equal(tf32, ref)}; under bf16 autocast: "
        f"{torch.equal(bf16, ref)}; a plain product of the masks is off by up to "
        f"{(naive_tf32.double() - exact).abs().max().item():g} px under TF32 and "
        f"{(naive_bf16.double() - exact).abs().max().item():g} px under bf16 autocast")
    if not (torch.equal(tf32, ref) and torch.equal(bf16, ref)):
        fail("GED^2 depends on TF32 or autocast")
    return k1_val_err


def _quant_npz(log_dir: str, samples: int):
    """test_quantitative's two files of best_ged in log_dir: their GED keys,
    the number of images, and whether they keep the npz contract."""
    import numpy as np

    stem = f"{samples}_best_ged"
    with np.load(os.path.join(log_dir, f"ged{stem}.npz")) as z:
        keys, n = sorted(z.keys()), len(z["arr_0"])
        ok = (keys == ["arr_0", "d_ss", "d_sy", "d_yy", "n_annotators", "n_samples"]
              and all(z[k].shape == (n,) and np.isfinite(z[k]).all()
                      for k in ("arr_0", "d_sy", "d_ss", "d_yy"))
              and int(z["n_samples"]) == samples and int(z["n_annotators"]) == 4
              and np.allclose(2 * z["d_sy"] - z["d_ss"] - z["d_yy"], z["arr_0"], atol=1e-5))
    with np.load(os.path.join(log_dir, f"ncc{stem}.npz")) as z:
        ok = ok and list(z.keys()) == ["arr_0"] and z["arr_0"].shape == (n,) and \
            np.isfinite(z["arr_0"]).all()
    return keys, n, ok


def phase_quantitative(val):
    """test_quantitative on best_ged through its CLI: the npz contract."""
    import numpy as np
    import torch

    from phiseg_tpu_torch.cli.test_quantitative import main as quant_main
    from phiseg_tpu_torch.data import get_dataset
    from phiseg_tpu_torch.engine.loading import load_experiment
    from phiseg_tpu_torch.engine.validation import make_quant_eval_fn

    log_dir = val["log_dir"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ged, ncc = quant_main([log_dir, "--samples", str(QUANT_SAMPLES), "--batch", str(QUANT_BATCH)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    keys, n, ok = _quant_npz(log_dir, QUANT_SAMPLES)
    say(f"test_quantitative best_ged, {QUANT_SAMPLES} samples, batch {QUANT_BATCH}: {n} test "
        f"images, keys {keys}; GED^2 {ged.mean():.6g} +- {ged.std():.6g}, S_NCC "
        f"{ncc.mean():.6g} +- {ncc.std():.6g}; {wall:.2f} s = {wall / n:.4f} s/image of wall "
        f"time (restore, data and logging included); peak device memory {peak:.3f} GiB")
    if n != 32 or not ok:
        fail("test_quantitative's files break the npz contract")

    cfg, model, _, _ = load_experiment(log_dir, "best_ged")
    data = get_dataset(cfg)
    x = torch.from_numpy(data.test.images[:QUANT_BATCH].astype(np.float32)[..., None]).cuda()
    ann = torch.from_numpy(np.transpose(data.test.labels[:QUANT_BATCH], (0, 3, 1, 2))).cuda()
    quant = make_quant_eval_fn(model, cfg, QUANT_SAMPLES)
    g = torch.Generator(device="cuda").manual_seed(0)
    dev = device_ms(lambda: quant(x, ann, g), iters=1, warmup=1, sleep_cycles=400_000_000)
    say(f"test_quantitative device time: {dev:.3f} ms per batch of {QUANT_BATCH} = "
        f"{dev / QUANT_BATCH:.3f} ms/image (CUDA events, host kept ahead, 1 call)")
    return {"s_per_image": wall / n, "device_ms_per_image": dev / QUANT_BATCH, "peak_gib": peak}


def _ncc_undefined_and_no_spread(probs, gt):
    """For (B,S,H,W,C) probabilities and (B,M,H,W,C) one-hot annotations:
    the images whose S_NCC is undefined, those where one of its two maps
    (E_ss, or an annotator's E_sy) has a population std of 0, the metric's
    own maps and std, and those where such a map is exactly constant."""
    import torch

    from phiseg_tpu_torch.metrics import population_std, variance_ncc_dist, variance_ncc_maps

    undef = ~torch.isfinite(variance_ncc_dist(probs, gt))
    e_ss, e_sy = variance_ncc_maps(probs, gt)
    maps = torch.cat([e_ss.unsqueeze(1), e_sy], 1).flatten(2)  # (B,1+M,HW)
    no_spread = (population_std(maps).squeeze(-1) == 0).any(-1)
    constant = (maps.amax(-1) == maps.amin(-1)).any(-1)
    return undef, no_spread, constant


def _undefined_ncc_explained(model, cfg, batches) -> int:
    """Each validation batch whose S_NCC came out undefined (NaN), drawn
    again from the generator state the validation drew it with, by the
    validation's own sampler on the model it validated: undefined on the
    same images, and on exactly those where a map of the metric has a
    population std of 0 (0/0, as in the JAX package); else the NaN is a
    fault. Returns the number of undefined images."""
    import torch

    from phiseg_tpu_torch.engine.train import make_sample_fn
    from phiseg_tpu_torch.nn.losses import one_hot

    n = 0
    for x, ann, device, state, sncc in batches:
        g = torch.Generator(device=device)
        g.set_state(state)
        probs = make_sample_fn(model, cfg.validation_samples)(x, g).transpose(0, 1)
        undef, no_spread, _ = _ncc_undefined_and_no_spread(probs, one_hot(ann, cfg.nlabels))
        if not torch.equal(undef, ~torch.isfinite(sncc)) or not torch.equal(undef, no_spread):
            fail(f"{cfg.experiment_name}: S_NCC undefined on images "
                 f"{(~torch.isfinite(sncc)).nonzero().flatten().tolist()} of a validation batch; "
                 f"drawn again undefined on {undef.nonzero().flatten().tolist()}, a map with std "
                 f"0 on {no_spread.nonzero().flatten().tolist()}")
        n += int(undef.sum())
    return n


def _undefined_ncc_is_no_spread(model, cfg, data) -> None:
    """S_NCC on the validation images, as validation draws them, is
    undefined (0/0) on exactly the images where one of its two maps (E_ss,
    or an annotator's E_sy) has a population std of 0, the metric's own maps
    and std; else the NaN would be a fault."""
    import torch

    from phiseg_tpu_torch.engine.train import make_sample_fn
    from phiseg_tpu_torch.nn.losses import one_hot

    n = min(32, data.validation.images.shape[0])
    x, ann, _ = (t.cuda() for t in _val_images(data, n))
    probs = make_sample_fn(model, cfg.validation_samples)(x, torch.Generator(device="cuda")
                                                          ).transpose(0, 1)  # (B,S,H,W,C)
    undef, no_spread, constant = _ncc_undefined_and_no_spread(probs, one_hot(ann, cfg.nlabels))
    batch_bn = copy.deepcopy(model).train()  # the batch's own BN statistics, on a copy
    with torch.no_grad():
        logits = batch_bn(x, one_hot(ann[:, 0], cfg.nlabels)).s_out_list[0]
    say(f"{cfg.experiment_name} S_NCC on {n} val images, eval mode: undefined on "
        f"{int(undef.sum())}; a map with std 0 on {int(no_spread.sum())} (exactly constant on "
        f"{int(constant.sum())}); {_saturated(probs):.4%} of the probabilities are exactly 0 or 1 "
        f"with the running BN statistics, {_saturated(torch.softmax(logits.float(), -1)):.4%} "
        f"with the batch's own")
    if not torch.equal(undef, no_spread):
        fail(f"{cfg.experiment_name}: S_NCC is undefined on other images than those whose maps "
             "do not spread")


def phase_families():
    """The Probabilistic U-Net and the deterministic U-Net at full width:
    VAL_ITERS steps through the train CLI with two validations each; K1 on
    each validation path against the plain CE, and each trained model's
    validation on the card against the CPU's; the ProbUNet's kernel step
    against its plain step; its 100-sample sampler.
    Returns each family's log dir, launches and memory layout of its level."""
    import numpy as np
    import torch

    from phiseg_tpu_torch.data import get_dataset
    from phiseg_tpu_torch.engine.train import build_model
    from phiseg_tpu_torch.experiments import get_experiment
    from phiseg_tpu_torch.nn.losses import one_hot
    from phiseg_tpu_torch.ops import fused_residual_ce as frce

    out = {}
    for name in FAMILY_EXPERIMENTS:
        cfg = get_experiment(name).replace(validation_frequency=VAL_FREQ,
                                           tensorboard_update_frequency=1)
        root = os.path.join(OUT_DIR, name)
        os.makedirs(root)
        cfg_path, log_dir = os.path.join(root, "config.json"), os.path.join(root, "log")
        cfg.save(cfg_path)
        n_images = min(cfg.synth_n_val, int(cfg.num_validation_images))
        per_val = _validation_k1(cfg, n_images)
        say(f"family: {name} ({cfg.model_family}) R={cfg.resolution_levels} n0={cfg.n0} "
            f"zdim0={cfg.zdim0} {cfg.image_size} batch {cfg.batch_size} {cfg.compute_dtype} "
            f"norm={cfg.norm} {cfg.optimizer} annotators {cfg.annotator_range} KL weight "
            f"{cfg.kl_divergence_loss_weight}; {VAL_ITERS} steps validating every {VAL_FREQ}")
        # S_NCC is undefined (0/0) on an image whose map E_ss (or an E_sy)
        # does not spread: where every softmax of a young model in eval mode
        # saturates to exactly 0 and 1, its draws are alike (one draw always
        # for the DetUNet, often for a young ProbUNet, whose samples are
        # 99.4% saturated at step 20). The JAX package and the reference give
        # NaN there too. Each validation's NaN is explained on its own draws;
        # below, on fresh ones, with the saturation held against the CPU's.
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer, launches, records, wall, recs = _train_with_validations(cfg_path, log_dir)
        peak = max(r["steps_peak_gib"] for r in records)
        _say_validations(records, per_val, f"{name} ")

        want_keys = ["residual_multinoulli_loss_lvl0", "total_loss"]
        if cfg.kl_divergence_loss_weight is not None:
            want_keys.append("KL_divergence_loss_lvl0")
        train_recs = [r for r in recs if "batch_total_loss" in r]
        keys = sorted(k[len("batch_"):] for k in train_recs[0] if k.startswith("batch_"))
        want_k1 = VAL_ITERS + 2 * per_val
        init = build_model(cfg, device="cpu", seed=cfg.seed).state_dict()
        trained = trainer.state.model.state_dict()
        params = [n for n, _ in trainer.state.model.named_parameters()]
        unchanged = [n for n in params if torch.equal(init[n], trained[n].cpu())]
        nonfinite = [n for n, t in trained.items() if not torch.isfinite(t).all()]
        step_ms = [1000.0 * cfg.batch_size / r["images_per_sec"] for r in train_recs[2:]]
        say(f"{name}: loss keys {keys}; total {train_recs[0]['batch_total_loss']:.6g} -> "
            f"{train_recs[-1]['batch_total_loss']:.6g}; {len(params)} parameter tensors, "
            f"unchanged {len(unchanged)}, non-finite {len(nonfinite)}; K1 "
            f"{launches['fused_residual_ce_fwd']} = {VAL_ITERS} steps + 2 x {per_val}, K2 "
            f"{launches['fused_residual_ce_bwd']}")
        say(f"{name} time: median step {statistics.median(step_ms):.3f} ms over steps 2.."
            f"{VAL_ITERS - 1} (each step synchronised for its log line); {wall:.2f} s of wall "
            f"time with 2 validations; peak device memory of the train steps {peak:.3f} GiB")
        if keys != sorted(want_keys):
            fail(f"{name} loss keys {keys}, not {sorted(want_keys)}")
        if unchanged or nonfinite:
            fail(f"{name} parameters unchanged: {unchanged[:5]}; non-finite: {nonfinite[:5]}")
        if launches["fused_residual_ce_fwd"] != want_k1 or \
                launches["fused_residual_ce_bwd"] != VAL_ITERS or launches["fused_residual_ce_dp"]:
            fail(f"{name} launches {launches}")

        # the kernels read the family's one f32 level in place
        data = get_dataset(cfg)
        x, s = data.train.next_batch(cfg.batch_size)
        x = torch.from_numpy(x).cuda()
        s = torch.from_numpy(s.astype(np.uint8)).cuda()
        with torch.no_grad():
            levels = trainer.state.model(x, one_hot(s, cfg.nlabels),
                                         generator=torch.Generator(device="cuda").manual_seed(9)
                                         ).s_out_list
        read = frce._levels_nchw(levels)
        layout = "planes" if frce._planes(read) else "rows"
        say(f"{name}: its level {tuple(levels[0].shape)} {levels[0].dtype} (strides "
            f"{levels[0].stride()}) is {layout} in memory; read in place "
            f"{read[0].data_ptr() == levels[0].data_ptr()}")
        if len(levels) != 1 or read[0].data_ptr() != levels[0].data_ptr():
            fail(f"{name}: the kernels do not read its one level in place")
        k1_err = _k1_on_the_validation_path(cfg, trainer.state.model, data)
        _validation_card_vs_cpu(cfg, trained, data)
        if cfg.model_family == "det_unet" or any(r["ncc_undefined"] for r in records):
            _undefined_ncc_is_no_spread(trainer.state.model, cfg, data)
        out[name] = {"log_dir": log_dir, "launches": launches, "k1_val_err": k1_err,
                     "val_launches": records[0]["launches"], "layout": layout}
        if cfg.model_family == "prob_unet":
            _kernel_vs_plain_step(cfg, x, s, head="likelihood.prediction")
            phase_sampler(trainer, f"trained {VAL_ITERS} steps above")
        del trainer
        torch.cuda.empty_cache()
    return out


def phase_predictions(log_dirs):
    """test_predictions through its CLI on best_dice of each log dir: the npz
    contract, s/image of wall time, device ms/image and peak memory."""
    import numpy as np
    import torch

    from phiseg_tpu_torch.cli.test_predictions import main as pred_main
    from phiseg_tpu_torch.data import get_dataset
    from phiseg_tpu_torch.engine.loading import load_experiment
    from phiseg_tpu_torch.engine.train import make_sample_fn
    from phiseg_tpu_torch.metrics import dice_per_label

    res = {}
    for name, log_dir in log_dirs.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        dice = pred_main([log_dir, "--samples", str(SAMPLES), "--batch", str(QUANT_BATCH)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with np.load(os.path.join(log_dir, "dice_best_dice.npz")) as z:
            keys, arr = list(z.keys()), z["arr_0"]
        ok = (keys == ["arr_0"] and arr.shape == (32, 2) and np.isfinite(arr).all()
              and ((arr >= 0) & (arr <= 1)).all() and np.array_equal(arr, dice))

        cfg, model, _, _ = load_experiment(log_dir, "best_dice")
        n = 1 if cfg.model_family == "det_unet" else SAMPLES
        data = get_dataset(cfg)
        x = torch.from_numpy(data.test.images[:QUANT_BATCH].astype(np.float32)[..., None]).cuda()
        s_sel = torch.from_numpy(data.test.labels[:QUANT_BATCH, :, :, 0].astype(np.int64)).cuda()
        sample = make_sample_fn(model, n)
        g = torch.Generator(device="cuda").manual_seed(0)
        dev = device_ms(lambda: dice_per_label(sample(x, g).mean(0).argmax(-1), s_sel, cfg.nlabels),
                        iters=1, warmup=1, sleep_cycles=400_000_000)
        say(f"test_predictions {name} best_dice, {n} samples, batch {QUANT_BATCH}: npz keys {keys} "
            f"{arr.shape}, foreground Dice {arr[:, 1].mean():.6g} +- {arr[:, 1].std():.6g}; "
            f"{wall:.2f} s = {wall / 32:.4f} s/image of wall time (restore, data and logging "
            f"included); device {dev:.3f} ms per batch = {dev / QUANT_BATCH:.3f} ms/image (CUDA "
            f"events, host kept ahead, 1 call); peak device memory {peak:.3f} GiB")
        if not ok:
            fail(f"test_predictions's file for {name} breaks the npz contract")
        res[name] = {"s_per_image": wall / 32, "device_ms_per_image": dev / QUANT_BATCH,
                     "peak_gib": peak}
        del model
    return res


# ---------------------------------------------------------------------------
# Phases 13-17: the other norms, elastic augmentation, the step profiler,
# eval --mesh and the figure CLIs
# ---------------------------------------------------------------------------

NORM_VARIANTS = ("group", "layer", "instance", "renorm")  # phase 13
NORM_STEPS = 10
NORM_F64_BATCH = 2
# phase 13: one f64 step on the card vs on the CPU (cuDNN vs the CPU's
# convolutions, sums in another order): f64 round-off (1.1e-16) amplified
# as far as phase 5's f32 runs show round-off is at init (~3e5), with room
NORM_F64_TOL = {"loss_rtol": 1e-9, "grad_rel": 1e-6, "stats_rel": 1e-9}
NORM_GRAD_FLOOR = 1e-6  # of the step's largest gradient entry: a tensor's scale at least
KERNEL_STEP_LOSS_TOL = 1e-6  # phase 13: kernel step vs plain step (the ProbUNet's: 1.1e-7)
ELASTIC_STEPS = 10           # phase 14
# phase 14: the warped images card vs CPU. The backward coordinates agree to
# about an f32 ulp at 128 px (1.5e-5 px) and the synthetic images change by
# at most 0.47 per px, so a pixel moves by under 1e-5.
ELASTIC_IMAGE_ATOL = 1e-5
ELASTIC_LABEL_TIE = 1e-4     # |p1 - p0| of the warped one-hot under which labels may differ
PROFILE_ITERS, PROFILE_STEPS = 12, "2:7"  # phase 15: the window, both ends included
# phase 16: in f32 the decode's activations are twice bf16's; batch 4 keeps
# the two ranks (200 rows each) and this process within the card's memory
MESH_EVAL_IMAGES, MESH_EVAL_BATCH = 8, 4
MESH_TOL = dict(rtol=1e-4, atol=1e-5)  # JAX tests/test_cli.py:72-92
FIG_SAMPLES, GIF_SAMPLES, FIG_IMAGES = 100, 20, 2  # phase 17
FIG_CHECK_SAMPLES = 8        # phase 17: draws of the f64 card-vs-CPU check


def _finite_losses(ld) -> bool:
    return all(math.isfinite(v) for v in ld.values())


def phase_norms():
    """The four other norms at full width: NORM_STEPS steps with
    augmentation through make_train_step (K1 and K2 once a step, every
    parameter moved, finite losses; renorm's step counters), a kernel step
    against a plain step, and one f64 step on the card against the CPU."""
    import numpy as np
    import torch

    from phiseg_tpu_torch.data import get_dataset
    from phiseg_tpu_torch.data.augment_device import make_augment_fn
    from phiseg_tpu_torch.engine.train import create_train_state, make_train_step
    from phiseg_tpu_torch.experiments import get_experiment
    from phiseg_tpu_torch.nn.normalization import BatchRenorm
    from phiseg_tpu_torch.ops import fused_residual_ce as frce

    out = {}
    base = get_experiment(EXPERIMENT)
    data = get_dataset(base)
    batches = [data.train.next_batch(base.batch_size) for _ in range(NORM_STEPS)]
    for norm in NORM_VARIANTS:
        cfg = base.replace(norm=norm)
        state = create_train_state(cfg, "cuda")
        init = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
        step = make_train_step(cfg, make_augment_fn(cfg.augmentation_options, cfg.nlabels))
        g = torch.Generator(device="cuda").manual_seed(cfg.seed + 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        frce.reset_launch_counts()
        times, losses = [], []
        for x, s in batches:
            x = torch.from_numpy(x).cuda()
            s = torch.from_numpy(s.astype(np.uint8)).cuda()
            t0 = time.perf_counter()
            ld = step(state, x, s, g)
            torch.cuda.synchronize()
            times.append(1000.0 * (time.perf_counter() - t0))
            losses.append({k: float(v) for k, v in ld.items()})
        launches = dict(frce.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        trained = state.model.state_dict()
        params = [n for n, _ in state.model.named_parameters()]
        unchanged = [n for n in params if torch.equal(init[n], trained[n].cpu())]
        counters = sorted({int(m.steps) for m in state.model.modules()
                           if isinstance(m, BatchRenorm)})
        med = statistics.median(times[2:])
        say(f"norm={norm}: {EXPERIMENT} full width, batch {cfg.batch_size}, {cfg.compute_dtype}, "
            f"augmentation on, {NORM_STEPS} steps through make_train_step: total "
            f"{losses[0]['total_loss']:.6g} -> {losses[-1]['total_loss']:.6g}, all finite "
            f"{all(map(_finite_losses, losses))}; {len(params)} parameter tensors, unchanged "
            f"{len(unchanged)}; launches {launches}"
            + (f"; renorm step counters {counters}" if norm == "renorm" else ""))
        say(f"norm={norm} time: median step {med:.3f} ms over steps 2..{NORM_STEPS - 1} (each "
            f"step synchronised; steps {', '.join(f'{t:.1f}' for t in times)}); peak device "
            f"memory {peak:.3f} GiB")
        if not all(map(_finite_losses, losses)) or unchanged:
            fail(f"norm={norm}: non-finite losses or parameters unchanged {unchanged[:5]}")
        if launches["fused_residual_ce_fwd"] != NORM_STEPS or \
                launches["fused_residual_ce_bwd"] != NORM_STEPS or launches["fused_residual_ce_dp"]:
            fail(f"norm={norm}: launches {launches} in {NORM_STEPS} steps")
        if norm == "renorm" and counters != [NORM_STEPS]:
            fail(f"renorm step counters read {counters}, not [{NORM_STEPS}]")
        del state, step
        torch.cuda.empty_cache()

        x, s = batches[0]
        x, s = torch.from_numpy(x).cuda(), torch.from_numpy(s.astype(np.uint8)).cuda()
        _kernel_vs_plain_step(cfg, x, s, head="likelihood.out", loss_tol=KERNEL_STEP_LOSS_TOL)
        torch.cuda.empty_cache()
        f64 = _norm_step_card_vs_cpu(cfg, init, batches[1])
        out[norm] = {"launches": launches, "median_step_ms": med, "peak_gib": peak, "f64": f64}
    return out


def _norm_step_card_vs_cpu(cfg, init, batch):
    """One f64 train step (model.double(), the plain CE) from the weights
    `init` on the card and on the CPU, NORM_F64_BATCH images, the same
    injected noise, no augmentation: losses, gradients before the optimiser
    and running statistics within NORM_F64_TOL."""
    import torch

    cfg64 = cfg.replace(compute_dtype="float64", batch_size=NORM_F64_BATCH)
    x = torch.from_numpy(batch[0][:NORM_F64_BATCH])
    s = torch.from_numpy(batch[1][:NORM_F64_BATCH].astype("uint8"))
    eps = _latent_eps(cfg64, NORM_F64_BATCH, torch.Generator().manual_seed(17))
    t0 = time.perf_counter()
    card = _step_once(cfg64, init, x, s, eps, torch.device("cuda"))
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = _step_once(cfg64, init, x, s, eps, torch.device("cpu"))
    t_cpu = time.perf_counter() - t0
    (ld_c, gr_c, rs_c), (ld_p, gr_p, rs_p) = card, cpu
    loss = max(abs(ld_c[k] - ld_p[k]) / abs(ld_p[k]) for k in ld_p)
    # A conv bias right before a norm that subtracts its per-channel mean
    # (instance over each image, renorm over the batch) has a gradient of
    # zero by construction: round-off alone on both devices. Each tensor is
    # held against its own largest entry or NORM_GRAD_FLOOR of the largest
    # gradient entry of the step, whichever is larger.
    top = max(float(t.abs().max()) for t in gr_p.values())
    floor = NORM_GRAD_FLOOR * top
    zero = sorted(n for n, t in gr_p.items() if float(t.abs().max()) < floor)
    grad, grad_at = max(((float((gr_c[n] - gr_p[n]).abs().max())
                          / max(float(gr_p[n].abs().max()), floor), n) for n in gr_p),
                        key=lambda t: t[0])
    stats, stats_at = _rel_max(rs_c, rs_p) if rs_p else (0.0, "none")
    dtypes = {str(t.dtype) for t in gr_c.values()}
    say(f"norm={cfg.norm} f64 step card vs CPU ({NORM_F64_BATCH} images, injected noise, plain "
        f"CE; {t_card:.2f} s card, {t_cpu:.2f} s CPU): worst loss rel {loss:.3e} (tol "
        f"{NORM_F64_TOL['loss_rtol']:g}); gradients worst max|diff|/max(max|CPU|, "
        f"{NORM_GRAD_FLOOR:g} x {top:.3e}) {grad:.3e} at {grad_at} (tol "
        f"{NORM_F64_TOL['grad_rel']:g}; {len(zero)} tensors below that floor, e.g. "
        f"{zero[:2]}, largest entry "
        f"{max((float(gr_p[n].abs().max()) for n in zero), default=0.0):.1e}), "
        f"all-parameter rel L2 "
        f"{_rel_l2(gr_c, gr_p):.3e}; running statistics worst {stats:.3e} at {stats_at} (tol "
        f"{NORM_F64_TOL['stats_rel']:g}); gradient dtypes {sorted(dtypes)}")
    if set(ld_c) != set(ld_p) or not (loss <= NORM_F64_TOL["loss_rtol"]
                                      and grad <= NORM_F64_TOL["grad_rel"]
                                      and stats <= NORM_F64_TOL["stats_rel"]) \
            or dtypes != {"torch.float64"}:
        fail(f"norm={cfg.norm}: the f64 step on the card disagrees with the CPU's")
    return {"loss_rel": loss, "grad_rel": grad, "stats_rel": stats}


def phase_elastic():
    """Elastic augmentation: one batch warped on the card and on the CPU
    with the same injected draws (the field included), the augmentation's
    device time with and without the field, and ELASTIC_STEPS train steps
    with it on."""
    import numpy as np
    import torch

    from phiseg_tpu_torch.data import get_dataset
    from phiseg_tpu_torch.data import augment_device as aug
    from phiseg_tpu_torch.engine.train import create_train_state, make_train_step
    from phiseg_tpu_torch.experiments import get_experiment
    from phiseg_tpu_torch.nn.losses import one_hot
    from phiseg_tpu_torch.ops import fused_residual_ce as frce

    base = get_experiment(EXPERIMENT)
    opts = dict(base.augmentation_options, do_elasticaug=True)
    cfg = base.replace(augmentation_options=opts)
    data = get_dataset(cfg)
    x, s = data.train.next_batch(cfg.batch_size)
    x, s = torch.from_numpy(x), torch.from_numpy(s.astype(np.uint8))
    b, h, w = s.shape
    params = aug.draw_params(b, h, w, opts, torch.Generator().manual_seed(21))
    params["do_geom"] = torch.ones(b, dtype=torch.bool)  # every image warped
    res = {}
    for dev in ("cuda", "cpu"):
        p = {k: v.to(dev) for k, v in params.items()}
        ys, xs = aug.coords_from_params(p, h, w, opts)
        res[dev] = [t.cpu() for t in aug.apply_augmentation(
            x.to(dev), one_hot(s.to(dev), cfg.nlabels), ys, xs, p["fliplr"], p["flipud"])]
    (xc, sc), (xp, sp) = res["cuda"], res["cpu"]
    img_err = (xc - xp).abs().max().item()
    moved = (xp - x).abs().max().item()
    fill = sp.sum(-1) == 0  # outside the warp: zero one-hot, label 0 on both devices
    tie = ((sp[..., 1] - sp[..., 0]).abs() < ELASTIC_LABEL_TIE) & ~fill
    differ = sc.argmax(-1) != sp.argmax(-1)
    say(f"elastic: {b} images {h}x{w} warped with the same draws (field, scale, rotation, flips; "
        f"every coin on) on the card and on the CPU: images max|diff| {img_err:.3e} (tol "
        f"{ELASTIC_IMAGE_ATOL:g}; the warp moved pixels by up to {moved:.3g}); labels differ on "
        f"{int(differ.sum())} px, {int((differ & ~tie).sum())} of them outside the "
        f"{int(tie.sum())} px where the warped one-hot ties (|p1-p0| < {ELASTIC_LABEL_TIE:g}; "
        f"{int(fill.sum())} px fall outside the warp and are zero-filled on both)")
    if not img_err <= ELASTIC_IMAGE_ATOL or (differ & ~tie).any() or not moved > 0.1:
        fail("the elastic warp on the card disagrees with the CPU's")

    xd, sd = x.cuda(), s.cuda()
    g = torch.Generator(device="cuda").manual_seed(3)
    fns = {"with the elastic field": aug.make_augment_fn(opts, cfg.nlabels),
           "without it": aug.make_augment_fn(base.augmentation_options, cfg.nlabels)}
    order = list(fns) + list(reversed(fns))
    # The host issues an augmentation's ~100 launches more slowly than the
    # card runs them, so CUDA events around queued calls would time the
    # host: the device time is the kernels' own, from torch.profiler.
    runs = [_kernel_ms(lambda: fns[k](xd, sd, g)) for k in order]
    ms = {k: (runs[order.index(k)] + runs[len(order) - 1 - order.index(k)]) / 2 for k in fns}
    if not all(t > 0 for t in runs):
        fail("the profiler saw no device time in the augmentation")
    call = {k: cuda_ms(lambda: fns[k](xd, sd, g), iters=20) for k in fns}
    say(f"elastic: device ms per augmentation of {b} images (draws, coordinates, warp, flips; "
        f"the kernels' time by torch.profiler, 10 calls a run, runs "
        f"{', '.join(f'{t:.4f}' for t in runs)}): "
        + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
        + "; per call incl. host issue (CUDA events, median of 20): "
        + ", ".join(f"{k} {v:.4f}" for k, v in call.items()))

    state = create_train_state(cfg, "cuda")
    step = make_train_step(cfg, aug.make_augment_fn(opts, cfg.nlabels))
    frce.reset_launch_counts()
    losses = []
    for _ in range(ELASTIC_STEPS):
        xb, sb = data.train.next_batch(cfg.batch_size)
        losses.append({k: float(v) for k, v in step(
            state, torch.from_numpy(xb).cuda(), torch.from_numpy(sb.astype(np.uint8)).cuda(),
            g).items()})
    launches = dict(frce.LAUNCHES)
    say(f"elastic: {ELASTIC_STEPS} steps of {EXPERIMENT} with do_elasticaug on: total "
        f"{losses[0]['total_loss']:.6g} -> {losses[-1]['total_loss']:.6g}, all finite "
        f"{all(map(_finite_losses, losses))}; launches {launches}")
    if not all(map(_finite_losses, losses)) or \
            launches["fused_residual_ce_fwd"] != ELASTIC_STEPS or \
            launches["fused_residual_ce_bwd"] != ELASTIC_STEPS:
        fail(f"the elastic run: launches {launches} or non-finite losses")
    return {"launches": launches, "ms": ms, "image_err": img_err}


def _device_intervals(events):
    """The union of the device events' [start, end) in microseconds."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for a, z in spans:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = a, z
        else:
            cur_e = max(cur_e, z)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def phase_profiler():
    """PROFILE_ITERS steps through the train CLI with PHISEG_PROFILE_DIR and
    PHISEG_PROFILE_STEPS: one trace of the window, read back: nonzero device
    time, K1 and K2 by their kernel names once per traced step, the window's
    device-busy share and its top device operations."""
    import collections

    from phiseg_tpu_torch.cli.train import main as train_main
    from phiseg_tpu_torch.experiments import get_experiment
    from phiseg_tpu_torch.ops import fused_residual_ce as frce

    root = os.path.join(OUT_DIR, "profile")
    prof_dir, log_dir = os.path.join(root, "trace"), os.path.join(root, "log")
    os.makedirs(root)
    cfg = get_experiment(EXPERIMENT).replace(num_iter=PROFILE_ITERS)
    cfg_path = os.path.join(root, "config.json")
    cfg.save(cfg_path)
    start, stop = (int(v) for v in PROFILE_STEPS.split(":"))
    traced = stop - start + 1
    os.environ["PHISEG_PROFILE_DIR"], os.environ["PHISEG_PROFILE_STEPS"] = prof_dir, PROFILE_STEPS
    try:
        frce.reset_launch_counts()
        t0 = time.perf_counter()
        trainer = train_main([cfg_path, "--log-dir", log_dir])
        wall = time.perf_counter() - t0
    finally:
        del os.environ["PHISEG_PROFILE_DIR"], os.environ["PHISEG_PROFILE_STEPS"]
    launches = dict(frce.LAUNCHES)
    files = sorted(os.listdir(prof_dir))
    if len(files) != 1 or trainer.profiler.traces != [os.path.join(prof_dir, files[0])]:
        fail(f"the profiled run wrote {files}, not one trace of its window")
    path = os.path.join(prof_dir, files[0])
    events, device = _trace_events(path)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1 = [e for e in kernels if "frce_fwd_kernel" in e["name"]]
    k2 = [e for e in kernels if "frce_bwd_kernel" in e["name"]]
    t_lo = min(e["ts"] for e in events)
    t_hi = max(e["ts"] + e["dur"] for e in events)
    busy = _device_intervals(device)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in device:
        by_name[e["name"]][0] += e["dur"]
        by_name[e["name"]][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    say(f"profiler: {PROFILE_ITERS} steps through the train CLI with PHISEG_PROFILE_STEPS="
        f"{PROFILE_STEPS} ({traced} steps traced), {wall:.2f} s; trace {files[0]} "
        f"({os.path.getsize(path) / 2 ** 20:.1f} MiB): {len(kernels)} kernels, device time "
        f"{sum(e['dur'] for e in device) / 1e3:.3f} ms (kernels "
        f"{sum(e['dur'] for e in kernels) / 1e3:.3f} ms) in a window of "
        f"{(t_hi - t_lo) / 1e3:.3f} ms; device busy {busy / (t_hi - t_lo):.2%} of it "
        f"({busy / 1e3 / traced:.3f} ms a step); K1 {len(k1)} launches "
        f"({sum(e['dur'] for e in k1) / len(k1) if k1 else 0:.2f} us each), K2 {len(k2)} "
        f"({sum(e['dur'] for e in k2) / len(k2) if k2 else 0:.2f} us each); run launches "
        f"{launches}")
    for name, (dur, n) in top:
        say(f"profiler top device op: {dur / 1e3:.3f} ms in {n} calls: {name[:110]}")
    if not busy > 0 or not kernels:
        fail("the profiled window holds no device time")
    if len(k1) != traced or len(k2) != traced:
        fail(f"the trace holds K1 {len(k1)} and K2 {len(k2)} launches, not {traced} each")
    if launches["fused_residual_ce_fwd"] != PROFILE_ITERS or \
            launches["fused_residual_ce_bwd"] != PROFILE_ITERS:
        fail(f"the profiled run launched {launches}")
    return {"k1": len(k1), "k2": len(k2), "busy_share": busy / (t_hi - t_lo),
            "device_ms_per_step": busy / 1e3 / traced, "launches": launches}


def phase_eval_mesh(log_dir):
    """test_quantitative and test_predictions split over two gloo ranks
    sharing the card (the CLIs' own rank function, started by spawn_ranks as
    phase 5 starts its ranks) against `--mesh 1` through the CLIs (one NCCL
    rank), MESH_EVAL_IMAGES test images in batches of MESH_EVAL_BATCH,
    SAMPLES draws, on phase 8's best_ged and best_dice weights in f32 with
    TF32 off in the ranks: the same
    GED^2, S_NCC and Dice within MESH_TOL, rank 0's files equal to what it
    returned. The ranks draw the same noise; a rank decodes SAMPLES/2 x B
    rows where one rank decodes SAMPLES x B, and cuDNN picks its algorithm
    by shape, so the compute dtype's round-off differs between the two: in
    bf16 that moves S_NCC by ~2.5e-4 relative on an H100 (PERF.md), which
    the comparison in f32 keeps out."""
    import glob

    import numpy as np
    import torch

    from phiseg_tpu_torch.cli import test_predictions, test_quantitative
    from phiseg_tpu_torch.engine.config import ExperimentConfig
    from phiseg_tpu_torch.parallel import spawn_ranks

    log32 = os.path.join(OUT_DIR, "mesh_eval", "log")
    os.makedirs(log32)
    cfg = ExperimentConfig.load(os.path.join(log_dir, "config.json"))
    cfg.replace(compute_dtype="float32").save(os.path.join(log32, "config.json"))
    for stem in ("model_best_ged.ckpt", "model_best_dice.ckpt"):
        for f in glob.glob(os.path.join(log_dir, f"{stem}-*.pt")):
            shutil.copy(f, log32)
    common = [log32, "--samples", str(SAMPLES), "--batch", str(MESH_EVAL_BATCH), "--max-images",
              str(MESH_EVAL_IMAGES)]
    kw = dict(log_dir=log32, num_samples=SAMPLES, batch=MESH_EVAL_BATCH,
              max_images=MESH_EVAL_IMAGES, device="cuda")

    def run(mod, n, argv, kwargs):  # --mesh 1 through the CLI; 2 gloo ranks on the card
        if n == 1:
            return mod.main(argv + ["--mesh", "1"], timeout=RANK_TIMEOUT)
        return spawn_ranks(mod._evaluate_rank, n, (kwargs, n), backend="gloo",
                           timeout=RANK_TIMEOUT)[0]

    torch.cuda.empty_cache()  # the ranks' samplers share the card with this process
    res = {}
    os.environ["NVIDIA_TF32_OVERRIDE"] = "0"  # the ranks' cuDNN and cuBLAS in true f32
    try:
        for n in (1, 2):
            t0 = time.perf_counter()
            try:
                ged, ncc = run(test_quantitative, n, common + ["--out-suffix", f"_mesh{n}"],
                               dict(kw, out_suffix=f"_mesh{n}"))
                t_quant = time.perf_counter() - t0
                dice = run(test_predictions, n, common, kw)
            except (RuntimeError, TimeoutError) as e:
                fail(f"eval --mesh {n}: {e}")
            t_all = time.perf_counter() - t0
            with np.load(os.path.join(log32, f"ged{SAMPLES}_best_ged_mesh{n}.npz")) as z:
                ok = np.array_equal(z["arr_0"], ged)
            with np.load(os.path.join(log32, "dice_best_dice.npz")) as z:
                ok = ok and np.array_equal(z["arr_0"], dice)
            res[n] = (ged, ncc, dice)
            say(f"eval --mesh {n} ({'gloo ranks sharing the card' if n == 2 else 'one NCCL rank'}"
                f", f32, TF32 off): {MESH_EVAL_IMAGES} images in batches of {MESH_EVAL_BATCH}, "
                f"{SAMPLES} samples: GED^2 "
                f"{ged.mean():.6g}, S_NCC {ncc.mean():.6g}, foreground Dice "
                f"{dice[:, 1].mean():.6g}; test_quantitative {t_quant:.2f} s, test_predictions "
                f"{t_all - t_quant:.2f} s incl. spawn and restore; files equal to rank 0's "
                f"arrays: {ok}")
            if not ok or ged.shape != (MESH_EVAL_IMAGES,) or dice.shape != (MESH_EVAL_IMAGES, 2):
                fail(f"eval --mesh {n}: wrong shapes or files")
    finally:
        del os.environ["NVIDIA_TF32_OVERRIDE"]
    errs = {}
    for name, a, b in zip(("GED^2", "S_NCC", "Dice"), res[2], res[1]):
        errs[name] = float(np.abs(a - b).max())
        if not np.allclose(a, b, **MESH_TOL):
            fail(f"eval --mesh 2 {name} differs from --mesh 1: {a} vs {b}")
    say("eval --mesh 2 vs --mesh 1: max|diff| " + ", ".join(f"{k} {v:.3e}" for k, v in
                                                           errs.items())
        + f" (rtol {MESH_TOL['rtol']:g}, atol {MESH_TOL['atol']:g})")
    return errs


def _figure_arrays(cfg, trained, x, gts, devices=("cuda", "cpu")):
    """The figure CLIs' compute on each device in f64, the same injected
    noise: compute_sample_maps (FIG_CHECK_SAMPLES draws), the construction
    arrays (PHiSeg) and the GIF frames of the sample masks."""
    import torch

    from phiseg_tpu_torch.cli.generate_samples import compute_sample_maps
    from phiseg_tpu_torch.cli.makegif_samples import frames
    from phiseg_tpu_torch.cli.sample_construction import construction_arrays
    from phiseg_tpu_torch.engine.train import build_model, make_sample_fn, make_sample_levels_fn

    cfg64 = cfg.replace(compute_dtype="float64")
    g = torch.Generator().manual_seed(31)
    model_cpu = build_model(cfg64, device="cpu")
    shapes = model_cpu.latent_shapes(1)
    eps_s = [torch.randn((FIG_CHECK_SAMPLES, *sh), generator=g, dtype=torch.float64)
             for sh in shapes]
    eps_1 = [e[:1] for e in eps_s]
    out = {}
    for dev in devices:
        m = model_cpu if dev == "cpu" else build_model(cfg64, device=dev)
        m.double().load_state_dict(trained)
        xd = x.to(dev, torch.float64)
        maps = compute_sample_maps(make_sample_fn(m, FIG_CHECK_SAMPLES), xd, gts.to(dev),
                                   cfg.nlabels, eps=[e.to(dev) for e in eps_s])
        res = {k: v.cpu() for k, v in maps.items()}
        if cfg.model_family == "phiseg":
            res.update({f"construction_{k}": v.cpu() for k, v in construction_arrays(
                make_sample_levels_fn(m, 1), xd, eps=[e.to(dev) for e in eps_1]).items()})
        res["frames"] = torch.from_numpy(frames(x[0, ..., 0].numpy(), res["masks"].numpy()))
        out[dev] = res
        del m
    return out


def phase_figures(log_dirs):
    """generate_samples on the PHiSeg and ProbUNet log dirs, sample_construction
    and makegif_samples on the PHiSeg's: their compute on the card against
    the CPU in f64, the compute's ms per image on the card, and each CLI end
    to end where its image library is on this machine (decided before the
    phase), its files read back."""
    import importlib.util

    import numpy as np
    import torch

    from phiseg_tpu_torch.cli import generate_samples, makegif_samples, sample_construction
    from phiseg_tpu_torch.data import get_dataset
    from phiseg_tpu_torch.engine.loading import load_experiment
    from phiseg_tpu_torch.engine.train import make_sample_fn, make_sample_levels_fn

    have = {m: importlib.util.find_spec(m) is not None for m in ("matplotlib", "PIL")}
    say(f"figures: matplotlib {'present' if have['matplotlib'] else 'absent'}, PIL "
        f"{'present' if have['PIL'] else 'absent'} on this machine; generate_samples and "
        f"sample_construction render with matplotlib, makegif_samples writes with PIL; a CLI "
        f"whose library is absent is not started (it would raise ImportError before its work)")
    res = {}
    for name, log_dir in log_dirs.items():
        cfg, model, _, _ = load_experiment(log_dir, "best_ged")
        data = get_dataset(cfg)
        x = torch.from_numpy(data.test.images[:1].astype(np.float32)[..., None])
        gts = torch.from_numpy(data.test.labels[0].astype(np.int64))

        # the compute on the card against the CPU, f64, the same noise
        arrays = _figure_arrays(cfg, model.state_dict(), x, gts)
        c, p = arrays["cuda"], arrays["cpu"]
        gaps = {k: ((c[k].double() - p[k].double()).abs().max()
                    / p[k].double().abs().max().clamp_min(1e-300)).item()
                for k in c if c[k].is_floating_point() and k != "frames"}
        probs = p["probs"]
        margin = (probs[..., 1] - probs[..., 0]).abs()
        mask_diff = c["masks"] != p["masks"]
        worst_margin = float(margin[mask_diff].max()) if mask_diff.any() else 0.0
        frames_equal = torch.equal(c["frames"], p["frames"])
        say(f"figures {name}: compute card vs CPU in f64 ({FIG_CHECK_SAMPLES} draws of test "
            f"image 0, injected noise): max|diff|/max " + ", ".join(
                f"{k} {v:.3e}" for k, v in gaps.items())
            + f" (tol {F64_GAP:g}); masks differ on {int(mask_diff.sum())} px (largest "
            f"|p1-p0| among them {worst_margin:.3e}, near-tie below {TIE:g}); GIF frames "
            f"equal {frames_equal}")
        if any(not v <= F64_GAP for v in gaps.values()) or worst_margin >= TIE or \
                (not frames_equal and not mask_diff.any()):
            fail(f"figures {name}: the card's figure arrays differ from the CPU's")
        if cfg.model_family == "phiseg" and \
                not torch.equal(c["construction_mask"], p["construction_mask"]):
            say(f"figures {name}: construction masks differ on "
                f"{int((c['construction_mask'] != p['construction_mask']).sum())} px")

        # ms per image of each compute on the card, the CLIs' settings
        xd, gd = x.cuda(), gts.cuda()
        sample_fn = make_sample_fn(model, FIG_SAMPLES)
        gen = torch.Generator(device="cuda").manual_seed(5)
        timing = {"generate_samples": lambda: generate_samples.compute_sample_maps(
            sample_fn, xd, gd, cfg.nlabels, gen)}
        if cfg.model_family == "phiseg":
            levels_fn, gif_fn = make_sample_levels_fn(model, 1), make_sample_fn(model, GIF_SAMPLES)
            timing["sample_construction"] = lambda: sample_construction.construction_arrays(
                levels_fn, xd, gen)
            timing["makegif_samples"] = lambda: makegif_samples.frames(
                x[0, ..., 0].numpy(), gif_fn(xd, gen)[:, 0].argmax(-1).cpu().numpy())
        ms = {}
        for k, fn in timing.items():
            ms[k] = cuda_ms(fn, iters=5, warmup=1)
        say(f"figures {name}: compute ms per image on the card, one image a call (CUDA events, "
            f"median of 5, host issue included): " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
            + f" ({FIG_SAMPLES} samples, construction 1 draw, GIF {GIF_SAMPLES} draws + frames)")

        # the CLIs end to end
        wall = {}
        runs = [("generate_samples", "matplotlib", lambda: generate_samples.main(
            [log_dir, "--samples", str(FIG_SAMPLES), "--indices", "0", "1"]))]
        if cfg.model_family == "phiseg":
            runs += [("sample_construction", "matplotlib",
                      lambda: sample_construction.main([log_dir, "--indices", "0", "1"])),
                     ("makegif_samples", "PIL", lambda: makegif_samples.main(
                         [log_dir, "--samples", str(GIF_SAMPLES), "--indices", "0", "1"]))]
        for cli, lib, run in runs:
            if not have[lib]:
                say(f"figures {name}: {cli} not run: {lib} is absent")
                continue
            t0 = time.perf_counter()
            out_dir = run()
            wall[cli] = (time.perf_counter() - t0) / FIG_IMAGES
            files = sorted(os.listdir(out_dir))
            from PIL import Image

            sizes = []
            for f in files:
                with Image.open(os.path.join(out_dir, f)) as im:
                    sizes.append((im.format, im.size, getattr(im, "n_frames", 1)))
            say(f"figures {name}: {cli} through its CLI, {FIG_IMAGES} images: "
                f"{wall[cli]:.3f} s/image of wall time (restore included); files {files} "
                f"{sizes}")
            want_frames = GIF_SAMPLES if cli == "makegif_samples" else 1
            if len(files) != FIG_IMAGES or any(n != want_frames or min(sz) < 64
                                               for _, sz, n in sizes):
                fail(f"figures {name}: {cli} wrote {files} {sizes}")
            if cli == "makegif_samples" and any(sz != (4 * cfg.image_hw[1], 4 * cfg.image_hw[0])
                                                for _, sz, _ in sizes):
                fail(f"figures {name}: GIF frames of size {sizes}")
        res[name] = {"gaps": gaps, "ms": ms, "cli_s_per_image": wall}
        del model
        torch.cuda.empty_cache()
    return res, have


LIDC_PATIENTS, LIDC_LESIONS = 40, 3  # phase 18: the fake pickle's patients and lesions each
LIDC_FAMILY_ITERS = 11  # phase 18: probunet / detunet steps, one validation at VAL_FREQ
HOST_AUG_STEPS = 8      # phase 18: phiseg_7_5 steps fed by host augmentation
LIDC_SAMPLE_IMAGES = 8  # phase 18: LIDC test images of the 100-sample inference
# phase 19: card (K1, cuDNN, TF32 off) vs the JAX package's CPU run stored in
# the fixture, both f32: the CPU parity tests hold 1e-4 (about twenty f32
# convolutions summed in another order); stated before the first chip run
JAX_CKPT_TOL = 1e-4
JAX_FIXTURE = os.path.join("tests", "data", "jax_checkpoint_small")


def _fake_lidc_pickle(path: str, hw: int = 128, seed: int = 0) -> dict:
    """A pickle of the structure of Stefan Knegt's LIDC crops: per lesion an
    f64 image in [0, 1), 4 annotator masks (discs about one centre whose
    radius differs by annotator, a lesion the loss can fit) and the patient's
    series_uid; LIDC_PATIENTS patients with LIDC_LESIONS lesions each."""
    import pickle

    import numpy as np

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:hw, :hw]
    data, k = {}, 0
    for p in range(LIDC_PATIENTS):
        for _ in range(LIDC_LESIONS):
            cy, cx = rng.uniform(0.3 * hw, 0.7 * hw, 2)
            r = rng.uniform(4, hw / 8)
            d2 = (yy - cy) ** 2 + (xx - cx) ** 2
            masks = [(d2 < (r * (0.7 + 0.2 * a)) ** 2).astype(np.uint8) for a in range(4)]
            image = 0.35 * rng.rand(hw, hw) + 0.5 * np.exp(-d2 / (2 * r * r))
            data[k] = {"image": np.clip(image, 0.0, 0.999), "masks": masks,
                       "series_uid": f"1.3.6.1.4.1.14519.5.2.1.{p:05d}"}
            k += 1
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return data


def _check_lidc_splits(splits, raw, hw: int = 128) -> None:
    """The HDF5 contract of tests/test_data.py:283-320 on the in-memory
    split: shapes, dtypes, the -0.5 offset, every lesion once, patients
    disjoint across the splits."""
    import numpy as np

    uids = {k: set(v["uids"].tolist()) for k, v in splits.items()}
    ok = (sum(v["images"].shape[0] for v in splits.values()) == len(raw)
          and all(v["images"].shape[1:] == (hw, hw) and v["images"].dtype == np.float64
                  and v["labels"].shape[1:] == (hw, hw, 4) and v["labels"].dtype == np.uint8
                  and v["uids"].dtype == np.int64 and -0.5 <= v["images"].min()
                  and v["images"].max() < 0.5 for v in splits.values())
          and not (uids["train"] & uids["val"]) and not (uids["train"] & uids["test"])
          and not (uids["val"] & uids["test"])
          and sum(map(len, uids.values())) == LIDC_PATIENTS)
    say("lidc split: " + ", ".join(f"{k} {v['images'].shape[0]} images of {len(uids[k])} "
                                    f"patients" for k, v in splits.items())
        + f"; images f64 in [{min(v['images'].min() for v in splits.values()):.4f}, "
        f"{max(v['images'].max() for v in splits.values()):.4f}], labels u8 (N,{hw},{hw},4), "
        f"uids i64; patients disjoint: {ok}")
    if not ok:
        fail("the LIDC split breaks the contract of prepare_data's HDF5")


def _lidc_run(name: str, splits, root: str, iters: int, host_augment: bool = False):
    """The registry's `name` trained `iters` steps on LIDCData.from_splits
    through the Trainer, validating every VAL_FREQ; with host augmentation
    the on-device one is off. Checks losses, moved
    parameters and launches (K1 once a step plus once per eval-loss call and
    ELBO draw of each validation, K2 once a step); prints time and memory.
    Returns (trainer, launches, median step ms)."""
    import torch

    from phiseg_tpu_torch.data.lidc import LIDCData
    from phiseg_tpu_torch.engine.train import build_model
    from phiseg_tpu_torch.engine.trainer import Trainer
    from phiseg_tpu_torch.experiments import get_experiment
    from phiseg_tpu_torch.nn.layers import ConvBlock

    cfg = get_experiment(name).replace(validation_frequency=VAL_FREQ,
                                       tensorboard_update_frequency=1)
    if host_augment:
        cfg = cfg.replace(augment_on_device=False)
    log_dir = os.path.join(root, name + ("_host_augment" if host_augment else ""))
    data = LIDCData.from_splits(cfg, splits, host_augment=host_augment)
    n_val = min(data.validation.images.shape[0], int(cfg.num_validation_images))
    per_val = _validation_k1(cfg, n_val)
    n_vals = len(range(VAL_FREQ, iters, VAL_FREQ))
    say(f"lidc: {name} ({cfg.model_family}, data {cfg.data_identifier}) "
        f"R={cfg.resolution_levels} L={cfg.latent_levels} n0={cfg.n0} {cfg.image_size} batch "
        f"{cfg.batch_size} {cfg.compute_dtype} norm={cfg.norm} {cfg.optimizer} annotators "
        f"{cfg.annotator_range}; {iters} steps, augmentation "
        f"{'on the host (numpy/scipy)' if host_augment else 'on the card'}, {n_vals} "
        f"validations over {n_val} images")

    seen, computed = set(), set()  # the model's input (dtype, device); its blocks' dtype

    def train():
        trainer = Trainer(cfg, log_dir=log_dir)
        model = trainer.state.model
        block = next(m for m in model.modules() if isinstance(m, ConvBlock))
        hooks = [model.register_forward_pre_hook(
                     lambda m, args: seen.add((args[0].dtype, args[0].device.type))),
                 block.register_forward_hook(lambda m, args, out: computed.add(out.dtype))]
        try:
            trainer.train(data, iters)
        finally:
            for h in hooks:
                h.remove()
        return trainer

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer, launches, records, wall, recs = _train_with_validations(
        None, log_dir, run=train, iters=iters)
    peak = max([r["steps_peak_gib"] for r in records]
               or [torch.cuda.max_memory_allocated() / 2 ** 30])
    _say_validations(records, per_val, f"lidc {name} ")
    train_recs = [r for r in recs if "batch_total_loss" in r]
    step_ms = statistics.median(1000.0 * cfg.batch_size / r["images_per_sec"]
                                for r in train_recs[2:])
    init = build_model(cfg, device="cpu", seed=cfg.seed).state_dict()
    trained = trainer.state.model.state_dict()
    params = [n for n, _ in trainer.state.model.named_parameters()]
    unchanged = [n for n in params if torch.equal(init[n], trained[n].cpu())]
    nonfinite = [n for n, t in trained.items() if not torch.isfinite(t).all()]
    want_k1 = iters + n_vals * per_val
    say(f"lidc {name}: total loss {train_recs[0]['batch_total_loss']:.6g} -> "
        f"{train_recs[-1]['batch_total_loss']:.6g}; {len(params)} parameter tensors, unchanged "
        f"{len(unchanged)}, non-finite {len(nonfinite)}; K1 {launches['fused_residual_ce_fwd']} "
        f"= {iters} steps + {n_vals} x {per_val}, K2 {launches['fused_residual_ce_bwd']}; the "
        f"model's input (dtype, device) {sorted(map(str, seen))}, its blocks compute in "
        f"{sorted(map(str, computed))}")
    say(f"lidc {name} time: median step {step_ms:.3f} ms over steps 2..{iters - 1} (each step "
        f"synchronised for its log line); {wall:.2f} s of wall time; peak device memory of the "
        f"train steps {peak:.3f} GiB")
    if unchanged or nonfinite:
        fail(f"lidc {name} parameters unchanged: {unchanged[:5]}; non-finite: {nonfinite[:5]}")
    if launches["fused_residual_ce_fwd"] != want_k1 or \
            launches["fused_residual_ce_bwd"] != iters or launches["fused_residual_ce_dp"]:
        fail(f"lidc {name} launches {launches}, not K1 x {want_k1} and K2 x {iters}")
    if seen != {(torch.float32, "cuda")} or computed != {cfg.dtype}:
        fail(f"lidc {name}: the f64 LIDC batches reach the model as {seen} and compute in "
             f"{computed}, not f32 on the card computed in {cfg.dtype}")
    return trainer, launches, step_ms


def phase_lidc():
    """The registry's LIDC experiments at full width on a fake LIDC pickle:
    phiseg_7_5 with two validations, probunet and detunet with one, a few
    phiseg_7_5 steps with host augmentation, and the 100-sample inference of
    the trained PHiSeg through InferenceEngine. Returns the launches of
    each run."""
    import importlib.util

    import numpy as np
    import torch

    from phiseg_tpu_torch.data.augment_host import augment_batch_host
    from phiseg_tpu_torch.data.batch_provider import canonicalise_aug_options
    from phiseg_tpu_torch.data.lidc import _read_pickle_chunked, split_lidc
    from phiseg_tpu_torch.engine.inference import InferenceEngine
    from phiseg_tpu_torch.experiments import get_experiment

    say(f"lidc: h5py importable on this machine: {importlib.util.find_spec('h5py') is not None} "
        "(the phase builds the dataset in memory, LIDCData.from_splits, either way)")
    root = os.path.join(OUT_DIR, "lidc")
    os.makedirs(root)
    pkl = os.path.join(root, "data_lidc.pickle")
    t0 = time.perf_counter()
    raw = _fake_lidc_pickle(pkl)
    t1 = time.perf_counter()
    splits = split_lidc(_read_pickle_chunked(pkl))
    t2 = time.perf_counter()
    say(f"lidc pickle: {len(raw)} lesions of {LIDC_PATIENTS} patients, "
        f"{os.path.getsize(pkl) / 2 ** 20:.1f} MiB, written in {t1 - t0:.2f} s; chunked read "
        f"and patient split {t2 - t1:.2f} s")
    _check_lidc_splits(splits, raw)

    out = {}
    trainer, out["phiseg_7_5"], step_ms = _lidc_run("phiseg_7_5", splits, root, VAL_ITERS)
    log_dir = trainer.log_dir
    del trainer
    for name in ("probunet", "detunet"):
        t, out[name], _ = _lidc_run(name, splits, root, LIDC_FAMILY_ITERS)
        del t
        torch.cuda.empty_cache()

    # host augmentation: its ms per batch on this machine's CPU, then steps fed by it
    cfg = get_experiment("phiseg_7_5")
    opts = canonicalise_aug_options(cfg.augmentation_options)
    x = splits["train"]["images"][:cfg.batch_size]
    y = splits["train"]["labels"][:cfg.batch_size, ..., 0]
    rng = np.random.RandomState(0)
    aug_ms = []
    for _ in range(5):
        a0 = time.perf_counter()
        augment_batch_host(x, y, opts, rng)
        aug_ms.append(1000.0 * (time.perf_counter() - a0))
    t, out["phiseg_7_5_host_augment"], host_step_ms = _lidc_run(
        "phiseg_7_5", splits, root, HOST_AUG_STEPS, host_augment=True)
    del t
    say(f"lidc host augmentation ({opts}): median {statistics.median(aug_ms):.3f} ms per batch "
        f"of {cfg.batch_size} 128x128 images on this machine's CPU (5 calls); median step "
        f"{host_step_ms:.3f} ms fed by it vs {step_ms:.3f} ms with the on-device augmentation")

    # 100-sample inference of the trained PHiSeg on LIDC test images
    engine = InferenceEngine.from_logdir(log_dir, "best_ged")
    # on the card already: a copy from pageable host memory would wait for the device
    xt = torch.from_numpy(
        splits["test"]["images"][:LIDC_SAMPLE_IMAGES].astype(np.float32)[..., None]).cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    probs = engine.sample_probs(xt, SAMPLES, g)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if probs.shape != (SAMPLES, xt.shape[0], 128, 128, 2) or \
            not torch.isfinite(probs).all() or \
            not torch.allclose(probs.sum(-1), torch.ones((), device="cuda"), atol=1e-5):
        fail(f"lidc inference: probabilities {tuple(probs.shape)}, finite and summing to 1?")
    dev = device_ms(lambda: engine.sample_probs(xt, SAMPLES, g), iters=1, warmup=1,
                    sleep_cycles=400_000_000)
    call = cuda_ms(lambda: engine.sample_probs(xt, SAMPLES, g), iters=3, warmup=0)
    say(f"lidc inference: {SAMPLES} samples of phiseg_7_5 (best_ged, {VAL_ITERS} steps) on "
        f"{LIDC_SAMPLE_IMAGES} LIDC test images through InferenceEngine.sample_probs: device "
        f"{dev:.3f} ms = {dev / LIDC_SAMPLE_IMAGES:.3f} ms/image (CUDA events, host kept ahead, "
        f"1 call); per call incl. host issue {call:.3f} ms = {call / LIDC_SAMPLE_IMAGES:.3f} "
        f"ms/image (median of 3); peak device memory {peak:.3f} GiB")
    del engine
    torch.cuda.empty_cache()
    return out


def phase_jax_checkpoint():
    """A checkpoint that phiseg_tpu wrote, read on the card: the committed
    fixture's sample probabilities and eval losses from its stored noise
    against the JAX package's (f32, TF32 off), then test_quantitative
    through its CLI on the log dir."""
    import numpy as np
    import torch

    from phiseg_tpu_torch.cli.test_quantitative import main as quant_main
    from phiseg_tpu_torch.engine.loading import load_experiment
    from phiseg_tpu_torch.engine.train import make_eval_loss_fn, make_sample_fn

    log_dir = os.path.join(OUT_DIR, "jax_checkpoint")
    shutil.copytree(os.path.join(ROOT, JAX_FIXTURE), log_dir)
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on")
    cfg, model, state, step = load_experiment(log_dir, "best_ged", device="cuda")
    with np.load(os.path.join(log_dir, "expected.npz")) as f:
        exp = dict(f)

    def levels(prefix):
        n = sum(k.startswith(prefix) for k in exp)
        return [torch.from_numpy(exp[f"{prefix}{i}"]).cuda() for i in range(n)]

    x = torch.from_numpy(exp["x"]).cuda()
    probs = make_sample_fn(model, exp["probs"].shape[0])(x, eps=levels("eps_prior_"))
    gap = float(np.abs(probs.cpu().numpy() - exp["probs"]).max())
    losses = make_eval_loss_fn(model, cfg)(x, torch.from_numpy(exp["s"]).cuda(),
                                           eps=levels("eps_post_"))
    # |card - JAX| per loss against atol + rtol |JAX|, both JAX_CKPT_TOL, as the CPU tests
    # hold it (a KL term of a young model can sit near 0)
    loss_gap = max(abs(float(v) - float(exp[f"loss_{k}"])) / (1 + abs(float(exp[f"loss_{k}"])))
                   for k, v in losses.items())
    keys_ok = sorted(losses) == sorted(k[len("loss_"):] for k in exp if k.startswith("loss_"))
    n_adam = len(state.optimizer.state)
    say(f"jax checkpoint: {JAX_FIXTURE} (phiseg_tpu, {cfg.experiment_name}: R="
        f"{cfg.resolution_levels} L={cfg.latent_levels} n0={cfg.n0} {cfg.image_size} "
        f"{cfg.compute_dtype}) restored at step {step} on the card with Adam state for "
        f"{n_adam} parameters; sample probabilities {tuple(probs.shape)} vs the JAX package's "
        f"(stored noise, f32, TF32 off): max abs gap {gap:.3e}; eval losses max "
        f"|gap| / (1 + |JAX|) {loss_gap:.3e} (tolerance {JAX_CKPT_TOL} for both)")
    if not keys_ok or gap > JAX_CKPT_TOL or loss_gap > JAX_CKPT_TOL or not n_adam:
        fail("the phiseg_tpu checkpoint does not reproduce the JAX package's outputs on the card")
    del model, state

    t0 = time.perf_counter()
    quant_main([log_dir, "--samples", str(QUANT_SAMPLES), "--batch", "4"])
    torch.cuda.synchronize()
    keys, n, ok = _quant_npz(log_dir, QUANT_SAMPLES)
    say(f"jax checkpoint: test_quantitative on its log dir, {QUANT_SAMPLES} samples: {n} "
        f"synthetic test images, keys {keys}, contract kept: {ok}; "
        f"{time.perf_counter() - t0:.2f} s of wall time")
    if n != cfg.synth_n_test or not ok:
        fail("test_quantitative's files on the phiseg_tpu log dir break the npz contract")
    return gap


BF16_STEPS = 10  # phase 20: Trainer steps of each norm run
# phase 20: one step with norm "batch" against one with "batch_bf16" from one
# state, noise and augmentation draw. Every batch-normalised block of the
# model ends in ReLU, which commutes with the cast to bf16, so the two steps
# compute the same function; batch_bf16 adds only its zero conv biases. Held
# as the kernel step is (phase 4): losses within BF16_STEP_LOSS_TOL relative,
# the gradients of the shared parameters within 3x the spread of two "batch"
# steps + 1e-3 (all-parameter relative L2). Stated before the first run.
BF16_STEP_LOSS_TOL = 1e-3
# phase 21: the committed phiseg_tpu log dirs (scripts/make_jax_resume_fixture.py),
# each with the step its run is carried on to and the JAX Trainer's losses of
# that run (None: the PHiSeg, which draws its own noise), and the tolerance of
# the DetUNets' losses against them (tests/test_torch_resume.py LOSS_RTOL)
JAX_RESUME_FIXTURE = os.path.join("tests", "data", "jax_logdir_resume")
JAX_RESUME_CASES = {"detunet": (6, "expected.npz"),
                    "detunet_batches": (5, "expected_batches.npz"),
                    "phiseg": (6, None)}
JAX_RESUME_STEP, JAX_RESUME_RTOL = 3, 1e-4


def _moved_and_finite(cfg, model):
    """(parameters equal to their seeded init, non-finite state entries)."""
    import torch

    from phiseg_tpu_torch.engine.train import build_model

    init = build_model(cfg, device="cpu", seed=cfg.seed).state_dict()
    trained = model.state_dict()
    unchanged = [n for n, _ in model.named_parameters() if torch.equal(init[n], trained[n].cpu())]
    return unchanged, [n for n, t in trained.items() if not torch.isfinite(t).all()]


def _bf16_norm_run(cfg, log_dir: str):
    """BF16_STEPS steps of `cfg` through the Trainer: launches, losses,
    median step ms (steps 2.., each synchronised for its log line), peak."""
    import torch

    from phiseg_tpu_torch.data import get_dataset
    from phiseg_tpu_torch.engine.trainer import Trainer
    from phiseg_tpu_torch.ops import fused_residual_ce as frce

    data = get_dataset(cfg)
    trainer = Trainer(cfg, log_dir=log_dir)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    frce.reset_launch_counts()
    trainer.train(data, BF16_STEPS)
    torch.cuda.synchronize()
    launches = dict(frce.LAUNCHES)
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        recs = [r for r in map(json.loads, f) if "batch_total_loss" in r]
    unchanged, nonfinite = _moved_and_finite(cfg, trainer.state.model)
    med = statistics.median(1000.0 * cfg.batch_size / r["images_per_sec"] for r in recs[2:])
    finite = all(math.isfinite(v) for r in recs for k, v in r.items() if k.startswith("batch_"))
    say(f"norm={cfg.norm} Trainer run: {BF16_STEPS} steps, total loss "
        f"{recs[0]['batch_total_loss']:.6g} -> {recs[-1]['batch_total_loss']:.6g}, all finite "
        f"{finite}; parameters unchanged {len(unchanged)}, non-finite state {len(nonfinite)}; "
        f"launches {launches}; median step {med:.3f} ms over steps 2..{BF16_STEPS - 1}; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    if [r["step"] for r in recs] != list(range(BF16_STEPS)) or not finite:
        fail(f"norm={cfg.norm}: logged steps {[r['step'] for r in recs]}, all finite {finite}")
    if unchanged or nonfinite:
        fail(f"norm={cfg.norm}: parameters unchanged {unchanged[:5]}, non-finite {nonfinite[:5]}")
    if launches["fused_residual_ce_fwd"] != BF16_STEPS or \
            launches["fused_residual_ce_bwd"] != BF16_STEPS or launches["fused_residual_ce_dp"]:
        fail(f"norm={cfg.norm}: launches {launches} in {BF16_STEPS} steps")
    return launches, med


def _batch_vs_batch_bf16_step(base, x, s):
    """One full-width step with norm "batch" (twice: the spread of the card's
    bf16 atomics) and one with "batch_bf16", from one saved state (batch_bf16's
    seeded init; its zero conv biases are the entries "batch" lacks), one
    noise draw and one augmentation draw."""
    import torch

    from phiseg_tpu_torch.data.augment_device import make_augment_fn
    from phiseg_tpu_torch.engine.train import create_train_state, make_train_step

    device = x.device
    cfg16 = base.replace(norm="batch_bf16")
    init = create_train_state(cfg16, device).model.state_dict()
    g = torch.Generator(device=device).manual_seed(7)
    eps = [torch.randn(shape, device=device, generator=g, dtype=base.dtype)
           for shape in create_train_state(base, device).model.latent_shapes(base.batch_size)]
    augment_fn = make_augment_fn(base.augmentation_options, base.nlabels)
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for name, cfg in (("batch", base), ("batch again", base), ("batch_bf16", cfg16)):
            state = create_train_state(cfg, device)
            missing, unexpected = state.model.load_state_dict(init, strict=False)
            if missing or (cfg is cfg16) == bool(unexpected):
                fail(f"{name}: the saved state leaves {missing} unset and has {unexpected} over")
            step = make_train_step(cfg, augment_fn=augment_fn)
            aug_gen = torch.Generator(device=device).manual_seed(8)
            losses = {k: float(v) for k, v in step(state, x, s, aug_gen, eps=eps).items()}
            runs[name] = losses, {n: p.grad.float() for n, p in state.model.named_parameters()}
    finally:
        torch.backends.cudnn.deterministic = False
    (ld_b, gr_b), (_, gr_b2), (ld_16, gr_16) = (runs[k] for k in ("batch", "batch again",
                                                                  "batch_bf16"))
    worst = max(abs(ld_16[k] - ld_b[k]) / abs(ld_b[k]) for k in ld_b)
    rel, noise = _rel_l2(gr_16, gr_b), _rel_l2(gr_b2, gr_b)
    bias = max(float(gr_16[n].abs().max()) for n in gr_16 if n not in gr_b)
    top = max(float(t.abs().max()) for t in gr_b.values())
    say(f"batch vs batch_bf16 step ({base.experiment_name}, full width, {base.compute_dtype}, "
        f"augmentation on, one state, noise and augmentation draw): worst loss relative "
        f"difference {worst:.3e} (tol {BF16_STEP_LOSS_TOL:g}); gradients of the shared "
        f"parameters, relative L2 {rel:.3e} (batch vs batch again {noise:.3e}; tol 3x that + "
        f"1e-3); batch_bf16's conv-bias gradients at most {bias:.3e} (largest gradient entry "
        f"{top:.3e})")
    if set(ld_16) != set(ld_b) or not worst <= BF16_STEP_LOSS_TOL or \
            not rel <= 3 * noise + 1e-3:
        fail("the batch_bf16 step disagrees with the batch step")
    return {"loss_rel": worst, "grad_rel_l2": rel, "grad_noise": noise}


def phase_batch_bf16():
    """`phiseg_7_5_synth` at full width with norm="batch_bf16" through the
    Trainer, in turns with norm="batch" (batch, bf16, bf16, batch), and one
    step of each from one state. Returns the first batch_bf16 run's launches."""
    import numpy as np
    import torch

    from phiseg_tpu_torch.data import get_dataset
    from phiseg_tpu_torch.experiments import get_experiment

    base = get_experiment(EXPERIMENT).replace(tensorboard_update_frequency=1)
    say(f"batch_bf16: {EXPERIMENT} R={base.resolution_levels} L={base.latent_levels} "
        f"n0={base.n0} {base.image_size} batch {base.batch_size} {base.compute_dtype}, "
        f"augmentation on; {BF16_STEPS} Trainer steps per run, norms in turns")
    meds, launches = {"batch": [], "batch_bf16": []}, None
    for i, norm in enumerate(("batch", "batch_bf16", "batch_bf16", "batch")):
        got, med = _bf16_norm_run(base.replace(norm=norm),
                                  os.path.join(OUT_DIR, "batch_bf16", f"{i}_{norm}"))
        meds[norm].append(med)
        if norm == "batch_bf16" and launches is None:
            launches = got
    say(f"batch_bf16 time: median step batch {', '.join(f'{m:.3f}' for m in meds['batch'])} ms, "
        f"batch_bf16 {', '.join(f'{m:.3f}' for m in meds['batch_bf16'])} ms (runs in turns "
        f"batch, bf16, bf16, batch; each step synchronised for its log line)")
    x, s = get_dataset(base).train.next_batch(base.batch_size)
    x = torch.from_numpy(x).cuda()
    s = torch.from_numpy(s.astype(np.uint8)).cuda()
    step = _batch_vs_batch_bf16_step(base, x, s)
    torch.cuda.empty_cache()
    return {"launches": launches, "median_step_ms": meds, "step": step}


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def phase_jax_resume():
    """The committed phiseg_tpu log dirs carried on by the port's Trainer on
    the card from step JAX_RESUME_STEP to each case's step, f32, TF32 off:
    a kernel step against plain steps from the resumed state; each run's
    step, launches, losses and checkpoint files; the DetUNets' losses
    against the JAX Trainer's resumed runs. Returns each run's launches."""
    import numpy as np
    import torch

    from phiseg_tpu_torch.data import get_dataset
    from phiseg_tpu_torch.engine.config import ExperimentConfig
    from phiseg_tpu_torch.engine.trainer import Trainer
    from phiseg_tpu_torch.ops import fused_residual_ce as frce

    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on")
    out = {}
    for name, (to, expected_file) in JAX_RESUME_CASES.items():
        log_dir = os.path.join(OUT_DIR, "jax_resume", name)
        shutil.copytree(os.path.join(ROOT, JAX_RESUME_FIXTURE, name), log_dir)
        kept = {f: _read_bytes(os.path.join(log_dir, f))
                for f in ("config.json", f"model.ckpt-{JAX_RESUME_STEP}.msgpack")}
        cfg = ExperimentConfig.load(os.path.join(log_dir, "config.json"))
        trainer = Trainer(cfg, log_dir=log_dir)
        resumed = (trainer.resumed_from, trainer.init_step, len(trainer.state.optimizer.state))
        # the kernels against the plain CE at this run's shapes, from its resumed state
        x, s = get_dataset(cfg).train.next_batch(cfg.batch_size)
        x, s = torch.from_numpy(x).cuda(), torch.from_numpy(s.astype(np.uint8)).cuda()
        head = "likelihood.out" if cfg.model_family == "phiseg" else "likelihood.prediction"
        _kernel_vs_plain_step(cfg, x, s, head=head, loss_tol=KERNEL_STEP_LOSS_TOL,
                              init=trainer.state.model.state_dict())
        frce.reset_launch_counts()
        trainer.train(get_dataset(cfg), to)
        torch.cuda.synchronize()
        launches = dict(frce.LAUNCHES)
        with open(os.path.join(log_dir, "metrics.jsonl")) as f:
            recs = [r for r in map(json.loads, f) if "batch_total_loss" in r]
        new = [r for r in recs if r["step"] >= JAX_RESUME_STEP]
        # the Trainer validates at the steps after the first that the frequency divides
        n_vals = sum(1 for st in range(JAX_RESUME_STEP + 1, to)
                     if st % cfg.validation_frequency == 0)
        want_k1 = (to - JAX_RESUME_STEP
                   + n_vals * _validation_k1(cfg, min(cfg.synth_n_val,
                                                      int(cfg.num_validation_images))))
        files_kept = all(_read_bytes(os.path.join(log_dir, f)) == b for f, b in kept.items())
        pt = os.path.exists(os.path.join(log_dir, f"model.ckpt-{to}.pt"))
        finite = all(math.isfinite(r["batch_total_loss"]) for r in new)
        say(f"jax resume {name}: {JAX_RESUME_FIXTURE}/{name} ({cfg.model_family}, R="
            f"{cfg.resolution_levels} L={cfg.latent_levels} n0={cfg.n0} {cfg.image_size} "
            f"{cfg.compute_dtype}) resumed from {resumed[0]} at step {resumed[1]} with Adam state "
            f"for {resumed[2]} parameters, trained to {trainer.state.step}: losses "
            f"{[round(r['batch_total_loss'], 6) for r in new]} (steps "
            f"{[r['step'] for r in new]}), all finite {finite}; launches {launches} (K1 = "
            f"{to - JAX_RESUME_STEP} steps + {n_vals} validation(s)); .pt latest at "
            f"{to} {pt}; config.json and the .msgpack unchanged {files_kept}")
        if resumed[:2] != ((JAX_RESUME_STEP, ".msgpack"), JAX_RESUME_STEP) or not resumed[2]:
            fail(f"jax resume {name}: resumed {resumed}")
        if [r["step"] for r in new] != list(range(JAX_RESUME_STEP, to)) or \
                not finite or not pt or not files_kept or trainer.state.step != to:
            fail(f"jax resume {name}: steps, losses or checkpoint files wrong")
        if launches["fused_residual_ce_fwd"] != want_k1 or launches["fused_residual_ce_dp"] or \
                launches["fused_residual_ce_bwd"] != to - JAX_RESUME_STEP:
            fail(f"jax resume {name}: launches {launches}, not K1 x {want_k1} and K2 x "
                 f"{to - JAX_RESUME_STEP}")
        gap = None
        if expected_file is not None:
            with np.load(os.path.join(ROOT, JAX_RESUME_FIXTURE, expected_file)) as f:
                expected = dict(f)
            keys = [k for k in expected if k != "steps"]
            gap = max(abs(r[k] - expected[k][i]) / abs(expected[k][i])
                      for k in keys for i, r in enumerate(new))
            say(f"jax resume {name}: losses of steps {list(expected['steps'])} vs the JAX "
                f"Trainer's resumed run ({expected_file}, CPU): worst relative gap {gap:.3e} "
                f"(tol {JAX_RESUME_RTOL:g}, as tests/test_torch_resume.py holds the CPU)")
            if list(expected["steps"]) != [r["step"] for r in new] or gap > JAX_RESUME_RTOL:
                fail(f"the resumed {name}'s losses on the card disagree with the JAX Trainer's")
        out[name] = {"launches": launches, "loss_gap": gap}
        del trainer
    return out


def main() -> None:
    smi = phase_device()
    phase_build()
    errs, times = phase_kernels()
    launches, cfg, trainer = phase_slice()
    layout, _ = phase_in_context(cfg)
    dp_outs, k3_err = phase_dp(cfg)
    phase_mesh1()
    phase_sampler(trainer, "trained in phase 3")
    val = phase_validate()
    k1_val_err = phase_metrics(val)
    phase_quantitative(val)
    fam = phase_families()
    phase_predictions({EXPERIMENT: val["log_dir"], **{n: f["log_dir"] for n, f in fam.items()}})
    norms = phase_norms()
    elastic = phase_elastic()
    prof = phase_profiler()
    phase_eval_mesh(val["log_dir"])
    phase_figures({EXPERIMENT: val["log_dir"],
                   FAMILY_EXPERIMENTS[0]: fam[FAMILY_EXPERIMENTS[0]]["log_dir"]})
    lidc = phase_lidc()
    phase_jax_checkpoint()
    bf16 = phase_batch_bf16()
    resumed = phase_jax_resume()

    import torch

    pixels = cfg.batch_size * cfg.image_hw[0] * cfg.image_hw[1]
    layout_l1, val_l1 = (fam[FAMILY_EXPERIMENTS[0]][k] for k in ("layout", "val_launches"))
    kernels = []
    for k in ("fwd", "bwd"):
        b_ms, b_by = bound_ms(*ce_work(cfg.latent_levels, pixels, cfg.nlabels, k == "bwd"))
        b1_ms, b1_by = bound_ms(*ce_work(1, pixels, cfg.nlabels, k == "bwd"))
        t = times[k, layout, 5]  # in the memory layout of the main path's levels
        t1, lib = times[k, layout_l1, 1], times["library", k]
        kernels.append(
            {"name": f"fused_residual_ce_{k}", "route": "cuda", "source": KERNEL_SOURCE,
             "replaces": TPU_KERNELS[k], "launches": launches[f"fused_residual_ce_{k}"],
             "max_abs_err": errs[k], "ms": t["cold"], "plain_ms": t["plain"],
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
             "ms_l2_warm": t["warm"], "ms_l2_cold_read_flush": t["cold_read"],
             "launches_validation_path": (val["launches"][f"fused_residual_ce_{k}"]
                                          - VAL_ITERS),
             "max_rel_err_validation_path": k1_val_err if k == "fwd" else None,
             "share_of_bound": b_ms / t["cold"], "layout": layout, "variant": t["variant"],
             # at L=1, B=12, 128x128, the U-Net families' shape (phase 11)
             "launches_l1": sum(f["launches"][f"fused_residual_ce_{k}"] for f in fam.values()),
             "launches_l1_per_validation": val_l1[f"fused_residual_ce_{k}"],
             "max_rel_err_validation_path_l1": (max(f["k1_val_err"] for f in fam.values())
                                                if k == "fwd" else None),
             "ms_l1": t1["cold"], "ms_l1_l2_warm": t1["warm"],
             "ms_l1_l2_cold_read_flush": t1["cold_read"], "plain_ms_l1": t1["plain"],
             "bound_ms_l1": b1_ms, "bound_by_l1": b1_by, "share_of_bound_l1": b1_ms / t1["cold"],
             "library_ms_l1": lib["cold"], "library_ms_l1_l2_warm": lib["warm"],
             "library_ms_l1_l2_cold_read_flush": lib["cold_read"], "layout_l1": layout_l1,
             # phases 13-15: the norm variants', the elastic run's and the
             # profiled run's launches, and the profiler's count in its window
             "launches_norms": {n: r["launches"][f"fused_residual_ce_{k}"]
                                for n, r in norms.items()},
             "launches_elastic": elastic["launches"][f"fused_residual_ce_{k}"],
             "launches_profiled_run": prof["launches"][f"fused_residual_ce_{k}"],
             "launches_in_profiled_window_trace": prof["k1" if k == "fwd" else "k2"],
             # phase 18: the registry's LIDC experiments, per run
             "launches_lidc": {n: r[f"fused_residual_ce_{k}"] for n, r in lidc.items()},
             # phase 20: a batch_bf16 run; phase 21: each phiseg_tpu run carried on
             "launches_batch_bf16": bf16["launches"][f"fused_residual_ce_{k}"],
             "launches_jax_resume": {n: r["launches"][f"fused_residual_ce_{k}"]
                                     for n, r in resumed.items()}})
    # K3 on one rank: K1 over its shard (the all_reduce moves L floats)
    b_ms, b_by = bound_ms(*ce_work(cfg.latent_levels, pixels // DP_WORLD, cfg.nlabels, False))
    kernels.append(
        {"name": "fused_residual_ce_dp", "route": "cuda K1/K2 per rank + all_reduce",
         "source": DP_SOURCE, "replaces": TPU_KERNELS["dp"],
         "launches": dp_outs[0]["launches"]["fused_residual_ce_dp"], "max_abs_err": k3_err,
         "ms": dp_outs[0]["k3_ms"], "plain_ms": dp_outs[0]["k3_plain_ms"],
         "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
         "launches_lidc": {n: r["fused_residual_ce_dp"] for n, r in lidc.items()},
         "launches_batch_bf16": bf16["launches"]["fused_residual_ce_dp"],
         "launches_jax_resume": {n: r["launches"]["fused_residual_ce_dp"]
                                 for n, r in resumed.items()}})
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
