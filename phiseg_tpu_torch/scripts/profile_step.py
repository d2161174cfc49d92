"""Profile the train step or the 100-sample sampler and print where the
device time goes (port of scripts/profile_step.py).

  python -m phiseg_tpu_torch profile_step train [OUTDIR]
  python -m phiseg_tpu_torch profile_step sampler [OUTDIR] [--batch 8]

`phiseg_7_5_synth` at full width in bf16, with the weights of its seed:
`train` takes 3 warm-up steps with on-device augmentation, then traces 10
more; `sampler` warms the 100-sample prior sampler (encode once, decode 100
draws) on `--batch` images (default 1), then traces 10 calls. One
torch.profiler session (utils/profiling.py) writes its Chrome trace into
OUTDIR (default logs/profile_<which>); read back, it gives the top device
ops by self device time with their calls, the device ms per step (per
image for the sampler), the device-busy share of the window, the fused CE
kernels' launches by name, and the peak device memory of the window. The
port's spans of the window (utils/profiling.span: `train_step` and its
`train_step.augment` / `.forward` / `.backward` / `.optimizer`, or the
sampler's `sample.encode` / `.decode` / `.softmax`) are listed by name with
their calls, host ms per unit and, where they carry CUDA events, device ms
per unit.

`--device` defaults to cuda, and without a card that raises; on the CPU a
trace holds host ops only, so the device figures read "not measured".
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

WARM_STEPS = 3
TRACED_CALLS = 10
SAMPLES = 100
TOP_OPS = 15  # device ops a report lists
# the fused residual CE's kernel names in a trace: K1 and K2
KERNEL_NAMES = {"K1": "frce_fwd_kernel", "K2": "frce_bwd_kernel"}


def capture(which: str, outdir: str, device="cuda", batch: int = 1, cfg=None) -> dict:
    """Run and trace `which`; returns the trace's summary
    (utils.profiling.summarize_trace) with the trace path, the units the
    window holds (steps, or images for the sampler), the peak device memory
    in GiB (None on the CPU), the fused CE launches the window made
    (`launches`, by the wrappers' counts) and the trace's K1 / K2 kernels
    by name (`named`), and `spans`: (name, calls, host ms, device ms or None)
    of the window's spans (utils.profiling.summarize_spans).
    `cfg` replaces the full-width bf16 `phiseg_7_5_synth`."""
    from phiseg_tpu_torch.data.augment_device import make_augment_fn
    from phiseg_tpu_torch.data.synthetic import make_synthetic_arrays
    from phiseg_tpu_torch.engine.train import create_train_state, make_sample_fn, make_train_step
    from phiseg_tpu_torch.experiments import get_experiment
    from phiseg_tpu_torch.ops import fused_residual_ce as frce
    from phiseg_tpu_torch.parallel.mesh import resolve_device
    from phiseg_tpu_torch.utils.profiling import (SPANS, ProfileSession, launches_named,
                                                  summarize_spans, summarize_trace)

    if which not in ("train", "sampler"):
        raise ValueError(f"profile 'train' or 'sampler', not {which!r}")
    device = resolve_device(device)
    on_card = device.type == "cuda"
    if cfg is None:
        cfg = get_experiment("phiseg_7_5_synth").replace(compute_dtype="bfloat16")
    state = create_train_state(cfg, device)
    x_np, y_np = make_synthetic_arrays(cfg.batch_size, cfg.image_hw,
                                       cfg.num_labels_per_subject, seed=0)
    x = torch.from_numpy(x_np[..., None]).to(device)
    s = torch.from_numpy(y_np[..., 0].astype(np.int64)).to(device)
    generator = torch.Generator(device=device).manual_seed(0)

    if which == "train":
        step = make_train_step(cfg, make_augment_fn(cfg.augmentation_options, cfg.nlabels))
        for _ in range(WARM_STEPS):
            step(state, x, s, generator)

        def work():
            for _ in range(TRACED_CALLS):
                step(state, x, s, generator)
        units = TRACED_CALLS
    else:
        if not 1 <= batch <= cfg.batch_size:
            raise ValueError(f"--batch must be 1..{cfg.batch_size}, not {batch}")
        sample = make_sample_fn(state.model, SAMPLES)
        xb = x[:batch]
        sample(xb, generator)

        def work():
            for _ in range(TRACED_CALLS):
                sample(xb, generator)
        units = TRACED_CALLS * batch

    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    frce.reset_launch_counts()
    session = ProfileSession(outdir, f"{which}_b{batch}" if which == "sampler" else which,
                             device)
    try:
        work()
    finally:
        path = session.stop()
    out = summarize_trace(path)
    out.update(which=which, batch=batch, units=units, trace=path,
               launches=dict(frce.LAUNCHES), device=str(device),
               peak_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30 if on_card else None,
               named={k: launches_named(out, name) for k, name in KERNEL_NAMES.items()},
               spans=summarize_spans(SPANS.records()))
    return out


def report(summary: dict) -> None:
    """Print the summary of `capture`: the window, the spans, the device's
    share of the window, and the top device ops."""
    per = "step" if summary["which"] == "train" else "image"
    on_card = summary["peak_gib"] is not None
    busy_ms = summary["busy_us"] / 1e3
    units = summary["units"]
    print(f"profile_step {summary['which']}"
          + (f" --batch {summary['batch']}" if summary["which"] == "sampler" else "")
          + f" on {summary['device']}: {units} {per}s in the window; "
          f"trace {summary['trace']}")
    print(f"spans (host ms stretched by the profiler), per {per}:")
    print(f"  {'calls':>6s} {'host ms':>9s} {'device ms':>9s}  name")
    for name, calls, host_ms, dev_ms in summary["spans"]:
        dev = "-" if dev_ms is None else f"{dev_ms / units:9.3f}"
        print(f"  {calls:6d} {host_ms / units:9.3f} {dev:>9s}  {name}")
    if not on_card:
        print("device time: not measured (a CPU run traces host ops only)")
        return
    print(f"window {summary['window_us'] / 1e3:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({summary['busy_us'] / summary['window_us']:.2%} of it), "
          f"{busy_ms / summary['units']:.3f} device ms per {per}, "
          f"{summary['kernels']} kernels, peak memory {summary['peak_gib']:.3f} GiB")
    print("fused CE kernels in the window: " + ", ".join(
        f"{k} ({KERNEL_NAMES[k]}) {n}" for k, n in summary["named"].items()))
    print(f"top {TOP_OPS} device ops by self device time:")
    print(f"  {'ms':>9s} {'calls':>6s} {'share':>6s}  name")
    for name, dur, calls in summary["ops"][:TOP_OPS]:
        print(f"  {dur / 1e3:9.3f} {calls:6d} {dur / summary['device_us']:6.1%}  {name[:100]}")


def main(argv=None):
    """Capture and print; returns the summary of `capture`."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("which", nargs="?", default="train", choices=["train", "sampler"])
    p.add_argument("outdir", nargs="?", default=None,
                   help="where the Chrome trace goes (default logs/profile_<which>)")
    p.add_argument("--batch", type=int, default=1, help="images a sampler call draws for")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run; cuda without a card raises")
    a = p.parse_args(argv)
    outdir = a.outdir or os.path.join("logs", f"profile_{a.which}")
    summary = capture(a.which, outdir, a.device, a.batch)
    report(summary)
    return summary


if __name__ == "__main__":
    main()
