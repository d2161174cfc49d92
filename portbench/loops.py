"""The three kinds of traffic a cell can drive, each one general loop that a
traffic file parameterises (`kind`, `batch`, `samples`, `warmup_units`,
`traced_units`, `check_units`):

  train   a closed loop of train steps: batches from the program's batch
          provider through the Trainer's prefetch thread and host-to-card
          copy, the step of engine.train.make_train_step (augmentation on
          the card, forward, objective, backward, Adam), the losses brought
          to the host every `tensorboard_update_frequency` steps;
  eval    a closed loop over the test split in batches: make_quant_eval_fn's
          prior draws, GED^2 and S_NCC of every image, brought to the host
          after each batch, as cli/test_quantitative does;
  sample  a closed loop of one sampler call at a time (make_sample_fn), each
          timed from the image's copy to the card until its probabilities
          are on the host.

Set-up makes the weights from the seed, builds the program, and warms up
every shape the loop uses; a training cell also takes its first three steps
there, through the loop's own call, and keeps what the check compares. After
the window, `release` frees the program and `check` recomputes with the
configuration's plain reference module (portbench/reference/__init__.py
says what it provides) what the program produced: the three steps of a
training cell, and a sample, drawn from the seed, of the window's eval
batches or sampler calls. The noise of each checked unit is replayed from
the program's generator state before that unit.
"""

from __future__ import annotations

import json
import random
import statistics
import time
import types
from typing import Dict, List

import numpy as np
import torch

from portbench.reference import augment as RA
from portbench.reference import metrics as RM
from portbench.weights import make_weights


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _median(xs) -> float:
    return float(statistics.median(xs))


class Loop:
    """One cell's program, its window and its check. `cfg` is the config
    file's "experiment", the program's config fields; `ref` the plain
    reference module that the config file names."""

    kind = ""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device, ref):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.ref = ref
        self.batch = int(traffic["batch"])
        self.noise_dtype = getattr(torch, cfg["compute_dtype"])
        self.rng = random.Random(seed)
        self.recording = False
        self.phases: Dict[str, float] = {}  # set-up seconds by phase
        self._t = time.perf_counter()

    def _mark(self, phase: str) -> None:
        now = time.perf_counter()
        self.phases[phase] = now - self._t
        self._t = now

    def _program(self):
        from phiseg_tpu_torch.engine.config import ExperimentConfig
        from phiseg_tpu_torch.engine.train import build_model

        self.ecfg = ExperimentConfig.from_json(json.dumps(self.cfg))
        self.w0 = make_weights(self.ref.param_spec(self.cfg), self.seed, self.device,
                               self.ref.init_std)
        with torch.device(self.device):
            model = build_model(self.ecfg, self.device)
        model.load_state_dict(self.w0, strict=True)
        self.gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self._mark("weights_and_model")
        return model

    def _dataset(self):
        from phiseg_tpu_torch.data import get_dataset

        return get_dataset(self.ecfg, seed=self.seed % 2 ** 31)

    def _noise(self, gstate: torch.Tensor, batch: int) -> List[torch.Tensor]:
        """The sampler's noise of one call, replayed: per latent level, finest
        first, (S, B, ...) in the compute dtype, from the generator state the
        call started from."""
        g = torch.Generator(device=self.device)
        g.set_state(gstate)
        return [torch.randn((self.traffic["samples"], *shape), generator=g, device=self.device,
                            dtype=self.noise_dtype)
                for shape in self.ref.latent_shapes(self.cfg, batch)]

    def warm_up(self) -> None:
        for _ in range(int(self.traffic["warmup_units"])):
            self.unit()
        _sync(self.device)
        self._mark("warm_up")

    def window(self, seconds: float) -> dict:
        """Units back to back until `seconds` have passed, then a sync: the
        units done and the seconds they took, each unit's host seconds."""
        self.recording = True
        per_unit, t0 = [], time.perf_counter()
        while True:
            per_unit.append(self.unit())
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(self.device)
        self.recording = False
        return {"units": len(per_unit), "seconds": time.perf_counter() - t0, "per_unit": per_unit}

    def traced(self, path: str) -> int:
        """`traced_units` more units under torch.profiler; the Chrome trace
        is written to `path`. Returns the units traced."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        n = int(self.traffic["traced_units"])
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                self.unit()
            _sync(self.device)
        prof.export_chrome_trace(path)
        return n

    def _reference_mode(self):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------


class TrainLoop(Loop):
    kind = "train"
    CHECK_STEPS = 3

    def setup(self) -> None:
        from phiseg_tpu_torch.data.augment_device import make_augment_fn
        from phiseg_tpu_torch.engine.train import TrainState, make_optimizer, make_train_step
        from phiseg_tpu_torch.engine.trainer import Trainer, _Prefetcher

        model = self._program()
        cfg = self.ecfg
        if cfg.batch_size != self.batch:
            raise ValueError(f"traffic batch {self.batch} is not the config's {cfg.batch_size}")
        self.state = TrainState(model=model, optimizer=make_optimizer(cfg, model.parameters()))
        augment = make_augment_fn(cfg.augmentation_options, cfg.nlabels) if cfg.augment_on_device else None
        self.step = make_train_step(cfg, augment)
        self.prefetch = _Prefetcher(self._dataset().train, cfg.batch_size)
        # the Trainer's host-to-card copy: images f32, labels uint8, non-blocking
        shim = types.SimpleNamespace(mesh=None, cfg=cfg, device=self.device)
        self.to_device = lambda x, s: Trainer._to_device(shim, x, s)
        self.freq = cfg.tensorboard_update_frequency
        self.reads: List[float] = []  # host clock at each read of the losses
        self._mark("data_and_step")

        # the first steps, through the loop's own call, kept for the check
        self.records, self.losses = [], []
        params = dict(model.named_parameters())
        for i in range(self.CHECK_STEPS):
            xb, sb = self.prefetch.next()
            self.records.append((xb.copy(), sb.copy(), self.gen.get_state()))
            self.losses.append(self._run_step(*self.to_device(xb, sb))["total_loss"])
            if i == 0:  # Adam's first moment after one step is 0.1 * the first gradient
                moments = {n: self.state.optimizer.state.get(p, {}).get("exp_avg")
                           for n, p in params.items()}
                self.first_grad = {n: torch.zeros_like(params[n]) if m is None else m / 0.1
                                   for n, m in moments.items()}
        self.after = {n: p.detach().clone() for n, p in params.items()}
        _sync(self.device)
        self._mark("checked_steps")
        self.warm_up()

    def _run_step(self, x, s):
        i = self.state.step
        losses = self.step(self.state, x, s, self.gen)
        if i % self.freq == 0:  # the Trainer's host read of the losses
            self.host_losses = {k: float(v) for k, v in losses.items()}
            self.reads.append(time.perf_counter())
        return losses

    def unit(self) -> float:
        """One step; returns the host seconds spent waiting for the batch
        and its copy to the card."""
        t = time.perf_counter()
        x, s = self.to_device(*self.prefetch.next())
        wait = time.perf_counter() - t
        self._run_step(x, s)
        return wait

    def release(self) -> None:
        self.prefetch.stop()
        self.program_out = ([float(v) for v in self.losses], self.first_grad,
                            {n: self.after[n] - self.w0[n] for n in self.after})
        del self.state, self.step, self.after, self.first_grad, self.losses

    def reference(self, prec: str = "f32", half_batch: bool = False):
        """The three checked steps in the reference: (losses, first
        gradients, change of the parameters), from the same weights,
        batches and generator states, the family's train state carried
        from step to step. `half_batch` plants the fault of a step that
        trains on half of its batch."""
        self._reference_mode()
        cfg, dev, ref = self.cfg, self.device, self.ref
        params = {n: t.clone() for n, t in self.w0.items()}
        names = ref.trainable(ref.param_spec(cfg))
        state = ref.train_state(cfg, params)
        opt = ref.optimizer(cfg, params, names)
        losses, first = [], None
        for i, (xb, sb, gstate) in enumerate(self.records):
            g = torch.Generator(device=dev)
            g.set_state(gstate)
            x = torch.from_numpy(xb).to(dev)
            s = torch.from_numpy(np.asarray(sb)).to(dev)
            if cfg["augment_on_device"]:
                x, s = RA.augment(x, s, cfg["nlabels"], cfg["augmentation_options"], g)
            if half_batch:
                x, s = x[: len(x) // 2], s[: len(s) // 2]

            def draw(shape, g=g):
                return torch.randn(shape, generator=g, device=dev, dtype=self.noise_dtype).float()

            loss, grads, state = ref.grad_step(cfg, params, x, s, draw, prec, generator=g,
                                               state=state)
            state = opt.step(params, grads, i, state)
            losses.append(float(loss))
            if first is None:
                first = grads
        return losses, first, {n: params[n] - self.w0[n] for n in names}

    def check(self) -> Dict[str, float]:
        return compare_train(self.program_out, self.reference())


def _norms(ts: Dict[str, torch.Tensor], names) -> Dict[str, float]:
    return {n: float(ts[n].double().norm()) for n in names}


def compare_train(cand, ref) -> Dict[str, float]:
    """loss_gap: the largest relative gap of the three steps' losses
    (loss_gap_1: the first step's alone). grad_gap: the worst leaf's gap
    between the norms of the first gradient, over the larger of the
    reference's norm of that leaf and of the median leaf. change_gap: the
    same of the change of the parameters over the three steps, over the
    leaves whose reference gradient is at least a thousandth of the median
    leaf's (the others move under Adam by round-off). The *_median numbers
    are the median leaf's gap instead of the worst's."""
    (lc, gc, cc), (lr, gr, cr) = cand, ref
    names = list(gr)
    loss = [abs(a - b) / abs(b) for a, b in zip(lc, lr)]
    ngr, ngc = _norms(gr, names), _norms(gc, names)
    med = _median(ngr.values())
    grad = [abs(ngc[n] - ngr[n]) / max(ngr[n], med) for n in names]
    moved = [n for n in names if ngr[n] >= 1e-3 * med]
    ncr, ncc = _norms(cr, moved), _norms(cc, moved)
    medc = _median(ncr.values())
    change = [abs(ncc[n] - ncr[n]) / max(ncr[n], medc) for n in moved]
    return {"loss_gap": max(loss), "loss_gap_1": loss[0], "grad_gap": max(grad),
            "grad_gap_median": _median(grad), "change_gap": max(change),
            "change_gap_median": _median(change), "leaves_left_out": float(len(names) - len(moved))}


# ---------------------------------------------------------------------------


class _Sampled(Loop):
    """A loop of sampler calls whose answers are kept for the check."""

    def _keep(self, item) -> None:
        """Reservoir sampling of `check_units` window units, from the seed."""
        if not self.recording:
            return
        k = int(self.traffic["check_units"])
        self.seen += 1
        if len(self.kept) < k:
            self.kept.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < k:
                self.kept[j] = item

    def _test_split(self):
        data = self._dataset()
        self.test_x = np.asarray(data.test.images, dtype=np.float32)           # (N, H, W)
        self.test_ann = np.transpose(np.asarray(data.test.labels), (0, 3, 1, 2)).astype(np.int32)
        self.kept, self.seen, self.count = [], 0, 0

    def release(self) -> None:
        del self.fn
        self.params = {n: t for n, t in self.w0.items()}


class EvalLoop(_Sampled):
    """The eval's answers are GED^2 and S_NCC per image; the probabilities
    they come from are taken where make_quant_eval_fn draws them (its
    make_sample_fn, wrapped at set-up so that each call's output is kept by
    reference), so that the check can judge the sampler and the metrics
    each on its own: a change of the program there needs a change of this
    benchmark."""

    kind = "eval"

    def setup(self) -> None:
        from phiseg_tpu_torch.engine import validation

        model = self._program()
        held, plain = {}, validation.make_sample_fn

        def keeping(*args, **kwargs):
            fn = plain(*args, **kwargs)

            def sample(*a, **k):
                held["probs"] = fn(*a, **k)
                return held["probs"]

            return sample

        validation.make_sample_fn = keeping
        try:
            self.fn = validation.make_quant_eval_fn(model, self.ecfg, int(self.traffic["samples"]))
        finally:
            validation.make_sample_fn = plain
        self.held = held
        self._test_split()
        self.starts = list(range(0, len(self.test_x) - self.batch + 1, self.batch))
        self._mark("data")
        self.warm_up()

    def unit(self) -> float:
        b0 = self.starts[self.count % len(self.starts)]
        self.count += 1
        gstate = self.gen.get_state()
        x = torch.from_numpy(self.test_x[b0:b0 + self.batch, ..., None]).to(self.device)
        ann = torch.from_numpy(self.test_ann[b0:b0 + self.batch]).to(self.device)
        ged, sncc, _ = self.fn(x, ann, self.gen)
        self._keep((b0, gstate, ged.cpu().numpy(), sncc.cpu().numpy(), self.held.pop("probs", None)))
        return 0.0

    def release(self) -> None:
        super().release()
        del self.held

    def answers(self, prec: str = "f32"):
        """Per kept batch, the reference's probabilities (S, B, H, W, C)."""
        self._reference_mode()
        out = []
        for b0, gstate, *_ in self.kept:
            eps = self._noise(gstate, self.batch)
            x = torch.from_numpy(self.test_x[b0:b0 + self.batch, ..., None]).to(self.device)
            out.append(torch.cat([self.ref.sample_probs(self.cfg, self.params, x[b:b + 1],
                                                        [e[:, b:b + 1] for e in eps], prec)
                                  for b in range(self.batch)], dim=1))
        return out

    def metrics_of(self, probs, round_bf16: bool = False):
        """The reference's (GED^2, S_NCC) of each image of each kept batch,
        from the given probabilities (rounded to bfloat16 first for the
        control)."""
        nl = self.cfg["nlabels"]
        out = []
        for (b0, *_), p in zip(self.kept, probs):
            if p is None:
                out.append(None)
                continue
            p = p.to(torch.bfloat16).float() if round_bf16 else p
            ann = torch.from_numpy(self.test_ann[b0:b0 + self.batch]).to(self.device)
            out.append((np.asarray([float(RM.ged(p[:, b].argmax(-1), ann[b], nl)) for b in range(p.shape[1])]),
                        np.asarray([float(RM.sncc(p[:, b], ann[b], nl)) for b in range(p.shape[1])])))
        return out

    def program_answers(self):
        """Per kept batch: (GED^2 (B,), S_NCC (B,), probabilities or None)."""
        return [(g, s, p) for _, _, g, s, p in self.kept]

    def check(self) -> Dict[str, float]:
        prog = self.program_answers()
        return compare_eval(prog, self.metrics_of([p for _, _, p in prog]), self.answers())


def _gap(a: np.ndarray, b: np.ndarray) -> float:
    """The largest absolute gap; NaN on both sides agrees, on one side, or a
    missing answer, is inf."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape or (np.isnan(a) != np.isnan(b)).any():
        return float("inf")
    both = ~np.isnan(a)
    return float(np.abs(a[both] - b[both]).max()) if both.any() else 0.0


def compare_eval(cand, judged, ref_probs) -> Dict[str, float]:
    """prob_gap: the largest absolute gap between the probabilities the
    eval drew and the reference's from the same noise (the encoder, the
    decode of every draw, the softmax). ged_gap and sncc_gap: the largest
    absolute gap between the eval's GED^2 and S_NCC of an image and the
    reference metrics of the same probabilities (`judged`). Each is inf
    where an answer is missing."""
    inf = float("inf")
    if any(p is None or j is None for (_, _, p), j in zip(cand, judged)):
        return {"prob_gap": inf, "ged_gap": inf, "sncc_gap": inf}
    return {
        "prob_gap": max(float((p.float() - r.float()).abs().max()) if p.shape == r.shape else inf
                        for (_, _, p), r in zip(cand, ref_probs)),
        "ged_gap": max(_gap(c[0], j[0]) for c, j in zip(cand, judged)),
        "sncc_gap": max(_gap(c[1], j[1]) for c, j in zip(cand, judged)),
    }


class SampleLoop(_Sampled):
    kind = "sample"

    def setup(self) -> None:
        from phiseg_tpu_torch.engine.train import make_sample_fn

        model = self._program()
        self.fn = make_sample_fn(model, int(self.traffic["samples"]))
        self._test_split()
        self._mark("data")
        self.warm_up()

    def unit(self) -> float:
        """One call; returns its latency in seconds, from the image's copy
        to the card until its probabilities are on the host."""
        i = self.count % len(self.test_x)
        self.count += 1
        t = time.perf_counter()
        gstate = self.gen.get_state()
        x = torch.from_numpy(self.test_x[i:i + self.batch, ..., None]).to(self.device)
        probs = self.fn(x, self.gen).cpu()
        lat = time.perf_counter() - t
        self._keep((i, gstate, probs))
        return lat

    def answers(self, prec: str = "f32"):
        self._reference_mode()
        out = []
        for i, gstate, _ in self.kept:
            x = torch.from_numpy(self.test_x[i:i + self.batch, ..., None]).to(self.device)
            out.append(self.ref.sample_probs(self.cfg, self.params, x,
                                             self._noise(gstate, self.batch), prec))
        return out

    def program_answers(self):
        return [p.to(self.device) for _, _, p in self.kept]

    def check(self) -> Dict[str, float]:
        return compare_sample(self.program_answers(), self.answers())


def compare_sample(cand, ref) -> Dict[str, float]:
    """prob_gap: the largest absolute gap of a probability over the checked
    calls; inf where a call's answer has another shape."""
    return {"prob_gap": max(float((c.float() - r.float()).abs().max()) if c.shape == r.shape
                            else float("inf") for c, r in zip(cand, ref))}


KINDS = {"train": TrainLoop, "eval": EvalLoop, "sample": SampleLoop}


def make_loop(cfg: dict, traffic: dict, seed: int, device, ref) -> Loop:
    """The traffic kind's loop over the program of `cfg`, checked against
    the reference module `ref`."""
    return KINDS[traffic["kind"]](cfg, traffic, seed, torch.device(device), ref)

