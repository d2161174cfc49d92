"""The readings that a cell's limits are set from, over many seeds in one
process (the benchmark's own runs do not run this):

    python3 portbench/control.py --workload <name> --seeds 1,2,3 [--control-seeds 3] [--seconds 3]
                                 [--head-scale 0.25]

For each seed: set-up and a short window as in a run, then the numbers the
check compares for the program against the float32 reference ("program"),
and for the first --control-seeds seeds the same numbers for the reference
itself computed with bfloat16 convolutions ("ref_bf16", the program's own
precision) and with float8 ones ("control", the precision below the
configuration's), and for a training cell the fault of a step that trains
on half its batch ("half_batch"). An eval cell's control also computes the
metrics from the program's probabilities rounded to bfloat16 (the precision
below their float32). --head-scale sets the Gaussian heads' initial scale
against He normal (the reference module's HEAD_SCALE, 0.25 in every run of
the model families) for a look at other weights. One JSON line per seed on
standard output.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if __name__ == "__main__":
    if sys.path and os.path.abspath(sys.path[0]) == HERE:
        sys.path.pop(0)
    sys.path.insert(0, ROOT)


def readings(workload: str, seed: int, seconds: float, control: bool, device: str = "cuda",
             root: str = ROOT, pkg=None, head_scale=None) -> dict:
    import torch

    from portbench.cells import Bench
    from portbench.loops import compare_eval, compare_sample, compare_train, make_loop

    bench = Bench(root, pkg)
    cell = bench.workload(workload)
    config = bench.config(cell)
    module = bench.reference(config)
    if head_scale is not None:
        module.HEAD_SCALE = head_scale
    loop = make_loop(config["experiment"], bench.traffic(cell), seed, device, module)
    t0 = time.perf_counter()
    loop.setup()
    setup = time.perf_counter() - t0
    win = loop.window(seconds)
    loop.release()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed, "head_scale": getattr(module, "HEAD_SCALE", None), "setup_s": setup,
           "units": win["units"]}
    if loop.kind == "train":
        ref = loop.reference()
        out["program"] = compare_train(loop.program_out, ref)
        if control:
            for key, kw in (("ref_bf16", dict(prec="bf16")), ("control", dict(prec="fp8")),
                            ("half_batch", dict(half_batch=True))):
                out[key] = compare_train(loop.reference(**kw), ref)
    elif loop.kind == "eval":
        ref, prog = loop.answers(), loop.program_answers()
        probs = [p for _, _, p in prog]
        judged = loop.metrics_of(probs)
        out["program"] = compare_eval(prog, judged, ref)
        if control:
            rounded = loop.metrics_of(probs, round_bf16=True)
            for key, prec, metrics in (("ref_bf16", "bf16", judged), ("control", "fp8", rounded)):
                cand = [(m[0], m[1], p) for m, p in zip(metrics, loop.answers(prec))]
                out[key] = compare_eval(cand, judged, ref)
    else:
        ref = loop.answers()
        out["program"] = compare_sample(loop.program_answers(), ref)
        if control:
            for key, prec in (("ref_bf16", "bf16"), ("control", "fp8")):
                out[key] = compare_sample(loop.answers(prec), ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--head-scale", type=float, default=None)
    args = ap.parse_args(argv)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        r = readings(args.workload, seed, args.seconds, i < args.control_seeds,
                     head_scale=args.head_scale)
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
