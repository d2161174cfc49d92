"""The comparison that decides `correct` fails what it must: the control
(the reference itself, in float8 where the configuration states bfloat16)
fails a committed limit of every cell, and a run whose timed path is broken
underneath reads `correct` false: a step that leaves its state unchanged,
one that trains on half its batch, a gradient altered where it is made, an
eval answer or a probability altered, half of an eval batch left out. An
unbroken run at the same size reads true. The tiny cells run float32 here,
so that the unbroken runs sit far inside the full-size limits."""

import json

import pytest
import torch

from portbench.tests.tiny import PKG, ROOT, write_bench

torch.set_num_threads(1)
SEED = 2 ** 31 + 3


def _limits(cell):
    with open(f"{PKG}/limits/{cell}.json") as f:
        return json.load(f)


def _fails(numbers, limits):
    return [k for k, v in limits.items() if not numbers[k] <= v]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tiny"))
    write_bench(d)
    return d


@pytest.fixture(scope="module")
def tiny_bf16(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tiny_bf16"))
    write_bench(d, compute_dtype="bfloat16")
    return d


@pytest.mark.parametrize("cell", ["phiseg_7_5-train"])
def test_the_control_fails_a_training_cell(cell, tiny_bf16):
    """At the tiny size: the float8 reference and the half-batch fault in the
    program's place each fail a limit."""
    from portbench.control import readings

    r = readings(cell, SEED, 0.2, True, "cpu", tiny_bf16, tiny_bf16)
    assert _fails(r["control"], _limits(cell)) and _fails(r["half_batch"], _limits(cell))


@pytest.mark.parametrize("cell", ["phiseg_7_5-sample_b1", "phiseg_7_5-eval_b8", "probunet-eval_b8"])
def test_the_control_fails_a_sampling_cell(cell, tmp_path):
    """At full width, with 2 samples of 1 or 2 images."""
    from portbench.control import readings

    (tmp_path / "traffic").mkdir()
    (tmp_path / "limits").mkdir()
    with open(f"{PKG}/traffic/{'sample_b1_s100' if 'sample' in cell else 'eval_b8_s100'}.json") as f:
        t = json.load(f)
    t.update(batch=min(t["batch"], 2), samples=2, warmup_units=1, check_units=1)
    with open(tmp_path / "traffic" / f"{'sample_b1_s100' if 'sample' in cell else 'eval_b8_s100'}.json", "w") as f:
        json.dump(t, f)
    with open(tmp_path / "limits" / f"{cell}.json", "w") as f:
        json.dump(_limits(cell), f)
    r = readings(cell, SEED, 0.1, True, "cpu", ROOT, str(tmp_path))
    assert not _fails(r["program"], _limits(cell))
    assert _fails(r["control"], _limits(cell))


def _run(cell, d, trace=False):
    from portbench import run

    result, _ = run.run_cell(cell, SEED, 0.3, trace, device="cpu", root=d, pkg=d)
    return result


@pytest.mark.parametrize("cell", ["phiseg_7_5-train", "phiseg_7_5-eval_b8", "probunet-eval_b8",
                                  "phiseg_7_5-sample_b1"])
def test_an_unbroken_run_is_correct(cell, tiny):
    assert _run(cell, tiny)["correct"]


def _broken_step(monkeypatch, fault):
    import phiseg_tpu_torch.engine.train as T

    plain = T.make_train_step

    def make(cfg, augment_fn=None, **kw):
        step = plain(cfg, augment_fn, **kw)

        def broken(state, x, s, generator=None, eps=None):
            if fault == "half_batch":
                x, s = x[: len(x) // 2], s[: len(s) // 2]
            if fault == "unchanged":
                before = {k: v.clone() for k, v in state.model.state_dict().items()}
            if fault == "gradient":
                opt_step = state.optimizer.step

                def doubled():
                    for p in state.model.parameters():
                        if p.grad is not None:
                            p.grad.mul_(2.0)
                    return opt_step()

                state.optimizer.step = doubled
            out = step(state, x, s, generator, eps)
            if fault == "unchanged":
                state.model.load_state_dict(before)
                state.optimizer.state.clear()
            if fault == "gradient":
                del state.optimizer.step
            return out

        return broken

    monkeypatch.setattr(T, "make_train_step", make)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "gradient"])
@pytest.mark.parametrize("cell", ["phiseg_7_5-train"])
def test_a_broken_step_is_not_correct(cell, fault, tiny, monkeypatch):
    _broken_step(monkeypatch, fault)
    assert not _run(cell, tiny)["correct"]


@pytest.mark.parametrize("fault", ["ged", "sncc", "probability", "half_batch"])
@pytest.mark.parametrize("cell", ["phiseg_7_5-eval_b8", "probunet-eval_b8"])
def test_a_broken_eval_is_not_correct(cell, fault, tiny, monkeypatch):
    import phiseg_tpu_torch.engine.validation as V

    plain_quant, plain_sample = V.make_quant_eval_fn, V.make_sample_fn
    if fault == "probability":
        def make_sample(*a, **k):
            fn = plain_sample(*a, **k)
            return lambda *x, **y: fn(*x, **y).clone().index_put_((torch.tensor([0]),), torch.tensor(0.5))
        monkeypatch.setattr(V, "make_sample_fn", make_sample)
    else:
        def make_quant(*a, **k):
            fn = plain_quant(*a, **k)

            def quant(x, ann, generator=None, eps=None):
                if fault == "half_batch":
                    return fn(x[: len(x) // 2], ann[: len(ann) // 2], generator, eps)
                ged, sncc, terms = fn(x, ann, generator, eps)
                if fault == "ged":
                    ged = ged.clone().index_add_(0, torch.tensor([0]), torch.tensor([1e-3]))
                else:
                    sncc = sncc.clone().index_add_(0, torch.tensor([0]), torch.tensor([1e-3]))
                return ged, sncc, terms

            return quant
        monkeypatch.setattr(V, "make_quant_eval_fn", make_quant)
    assert not _run(cell, tiny)["correct"]


def test_an_altered_probability_is_not_correct(tiny, monkeypatch):
    import phiseg_tpu_torch.engine.train as T

    plain = T.make_sample_fn

    def make(*a, **k):
        fn = plain(*a, **k)

        def sample(x, generator=None, eps=None):
            p = fn(x, generator, eps).clone()
            c = int(p[0, 0, 0, 0].argmax())  # one pixel of one draw given the other class
            p[0, 0, 0, 0] = torch.nn.functional.one_hot(torch.tensor(1 - c), 2).float()
            return p

        return sample

    monkeypatch.setattr(T, "make_sample_fn", make)
    assert not _run("phiseg_7_5-sample_b1", tiny)["correct"]
