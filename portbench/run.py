"""Run one cell of BENCHMARK.json once and print its result as the last line
of standard output:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

With --trace 0 the result's metrics are the cell's end-to-end ones, with
--trace 1 its per-layer ones, read from an untraced window of --seconds and
then `traced_units` more units under torch.profiler. Without the cards the
cell asks for, it exits 2 and prints no result. The numbers that decide
`correct` are printed beside their limits, as the last lines of standard
error and under the result's last key, "compared".
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if __name__ == "__main__":
    # run as a script: this directory's modules must not shadow the standard
    # library's, and the checkout's root holds the program
    if sys.path and os.path.abspath(sys.path[0]) == HERE:
        sys.path.pop(0)
    sys.path.insert(0, ROOT)
    # every kernel cache at a fixed path inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(ROOT, ".portbench_cache", sub)

# modules that no run may load, compared by their whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "phiseg_tpu")


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Context:
    """What a metric's reader reads: the cell, its reference module, the
    untraced window, the trace summary (None without --trace 1) and the
    set-up seconds."""

    def __init__(self, cfg, ref, traffic, device_name, setup_s, window, batch):
        self.cfg, self.ref, self.traffic, self.device_name = cfg, ref, traffic, device_name
        self.kind = traffic["kind"]
        self.setup_s = setup_s
        self.units = window["units"]
        self.seconds = window["seconds"]
        self.per_unit = window["per_unit"]
        self.images = self.units * batch
        self.batch = batch
        self.trace = None
        self.trace_units = 0

    def flops_per_unit(self) -> int:
        from portbench.counts import unit_flops

        return unit_flops(self.ref, self.cfg, self.traffic)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             root: str = ROOT, pkg=None):
    """Run the cell; returns (result dict, [(name, value, limit)])."""
    import torch

    from portbench import tracefile
    from portbench.cells import Bench
    from portbench.loops import make_loop

    bench = Bench(root, pkg)
    cell = bench.workload(workload)
    config = bench.config(cell)
    traffic, limits = bench.traffic(cell), bench.limits(cell)
    cfg, ref = config["experiment"], bench.reference(config)
    loop = make_loop(cfg, traffic, seed, device, ref)
    loop.phases["start"] = time.perf_counter() - T_START
    loop.setup()
    setup_s = time.perf_counter() - T_START
    window = loop.window(seconds)
    dev = torch.device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    ctx = Context(cfg, ref, traffic, name, setup_s, window, loop.batch)
    info = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": name, "count": 1}
    if trace:
        fd, path = tempfile.mkstemp(suffix=".trace.json")
        os.close(fd)
        try:
            ctx.trace_units = loop.traced(path)
            ctx.trace = tracefile.summarize(path)
        finally:
            os.remove(path)
        info["busy_s"] = ctx.trace["busy_us"] / 1e6
        info["window_s"] = ctx.trace["window_us"] / 1e6
    info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    loop.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    compared = loop.check()

    metrics = {}
    for m in bench.metrics_for(cell, trace):
        value = bench.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = [(k, float(compared[k]), float(v)) for k, v in limits.items()]
    correct = all(value <= limit for _, value, limit in checks)  # NaN compares false
    result = {"correct": correct, "attempted": window["units"], "failed": 0,
              "metrics": metrics, "device": info}
    if trace:
        result["breakdown"] = {
            "device_ops": [[n, d / 1e6] for n, d, _ in ctx.trace["ops"][:10]],
            "idle_gaps": [[n, d / 1e6] for n, d in ctx.trace["gaps"][:10]],
        }
    result["compared"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    print("set-up seconds by phase: " + json.dumps(loop.phases), file=sys.stderr)
    reads = getattr(loop, "reads", [])
    if len(reads) > 1:
        print("seconds between the host's reads of the losses: "
              + json.dumps([round(b - a, 4) for a, b in zip(reads, reads[1:])]), file=sys.stderr)
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench.cells import Bench

    chips = Bench(ROOT).workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_loaded()
    if bad:
        print(f"portbench: modules that a run may not load are loaded: {bad}", file=sys.stderr)
        return 3
    for k, value, limit in checks:
        print(f"{k} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
