"""The port's checkpoint manager: tags, retention, archives, atomic writes,
hardlinked multi-tag saves, the async writer, and resume of the model, the
optimiser, the step and the generator (the cases of tests/test_checkpoint.py,
plus in-place updates after an async save)."""

import json
import os

import numpy as np
import pytest
import torch

from phiseg_tpu_torch.engine.checkpoint import (
    CheckpointManager,
    HostState,
    host_snapshot,
    write_metrics_jsonl,
)
from phiseg_tpu_torch.engine.config import ExperimentConfig
from phiseg_tpu_torch.engine.train import create_train_state, make_train_step

torch.set_num_threads(1)
CFG = ExperimentConfig(model_family="phiseg", latent_levels=2, resolution_levels=4, n0=2,
                       zdim0=2, image_size=(16, 16, 1), compute_dtype="float32", norm="batch",
                       batch_size=2)


def _trained_state(steps=2, seed=0):
    """A state whose optimiser has moments and BN statistics have moved."""
    state = create_train_state(CFG, device="cpu", seed=seed)
    step = make_train_step(CFG)
    g = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        step(state, torch.randn(2, 16, 16, 1, generator=g),
             torch.randint(0, 2, (2, 16, 16), generator=g), g)
    return state


@pytest.fixture
def state():
    return _trained_state()


def _same_state(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    for i, st in oa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    assert a.step == b.step


def test_save_restore_roundtrip(tmp_path, state):
    mgr = CheckpointManager(str(tmp_path))
    g = torch.Generator().manual_seed(5)
    torch.randn(3, generator=g)
    mgr.save(host_snapshot(state, g), "latest", step=5)
    assert os.path.exists(tmp_path / "model.ckpt-5.pt")

    fresh = create_train_state(CFG, device="cpu", seed=42)
    g2 = torch.Generator()
    restored, step = mgr.restore(fresh, "latest", generator=g2)
    assert step == 5 and restored is fresh
    _same_state(restored, state)
    assert torch.equal(torch.randn(4, generator=g2), torch.randn(4, generator=g))
    # BN running statistics are part of the model's state
    assert any("running_var" in k for k in restored.model.state_dict())


def test_checkpoint_is_a_plain_weights_only_dict(tmp_path, state):
    path = CheckpointManager(str(tmp_path)).save(state, "best_ged")
    ckpt = torch.load(path, weights_only=True)
    assert sorted(ckpt) == ["generator", "model", "optimizer", "step"]
    assert ckpt["step"] == state.step == 2 and ckpt["generator"] is None
    assert os.path.basename(path) == "model_best_ged.ckpt-2.pt"


def test_all_tags(tmp_path, state):
    mgr = CheckpointManager(str(tmp_path))
    for tag in ("latest", "best_loss", "best_dice", "best_ged", "best_ncc"):
        mgr.save(state, tag, step=1)
        assert mgr.has_checkpoint(tag)
    assert not mgr.has_checkpoint("archive")


def test_retention_policy(tmp_path, state):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(state, "best_dice", step=step)
    assert mgr._list_steps("best_dice") == [3, 4]
    for step in (1, 2, 3):  # latest keeps only 1 by default
        mgr.save(state, "latest", step=step)
    assert mgr._list_steps("latest") == [3]


def test_archive_checkpoints_time_based(tmp_path, state):
    """Every-N-hours archive saves, never pruned (ref
    keep_checkpoint_every_n_hours=3, phiseg_model.py:144)."""
    mgr = CheckpointManager(str(tmp_path), keep=1, archive_every_hours=1.0)
    assert mgr.maybe_archive(state) is None  # the interval has not passed
    mgr._last_archive_time -= 3601.0
    p = mgr.maybe_archive(state)
    assert p is not None and os.path.exists(p)
    assert mgr.maybe_archive(state) is None  # the interval restarts
    mgr._last_archive_time -= 3601.0
    state.step += 7
    mgr.maybe_archive(state)
    assert len(mgr._list_steps("archive")) == 2  # exempt from keep=1
    off = CheckpointManager(str(tmp_path / "off"), archive_every_hours=None)
    off._last_archive_time = 0.0
    assert off.maybe_archive(state) is None
    # a resumed manager starts its clock at the newest archive file
    assert CheckpointManager(str(tmp_path), archive_every_hours=1.0).maybe_archive(state) is None


def test_latest_step_and_missing(tmp_path, state):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step("latest") is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(state, "latest")
    mgr.save(state, "latest", step=7)
    mgr.save(state, "latest", step=9)
    assert mgr.latest_step("latest") == 9


def test_bad_tag(tmp_path, state):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(ValueError):
        mgr.save(state, "best_bogus")
    with pytest.raises(ValueError):
        mgr.restore(state, "best_bogus")


def test_no_tmp_leftovers(tmp_path, state):
    CheckpointManager(str(tmp_path)).save(state, "latest", step=1)
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))


def test_metrics_jsonl(tmp_path):
    path = str(tmp_path / "m.jsonl")
    write_metrics_jsonl(path, 1, {"loss": torch.tensor(2.5), "tag": "x"})
    write_metrics_jsonl(path, 2, {"loss": np.float32(1.5)})
    lines = [json.loads(line) for line in open(path)]
    assert lines[0] == {"step": 1, "loss": 2.5, "tag": "x"}
    assert lines[1] == {"step": 2, "loss": 1.5}


def test_multi_tag_save_reuses_the_file(tmp_path):
    """The same snapshot saved under several tags at one step is written
    once and hardlinked (the validation saves latest + up to 4 best_*)."""
    st = HostState(model={"w": torch.ones(64, 64)}, optimizer={}, step=7)
    m = CheckpointManager(str(tmp_path), keep=3)
    p1 = m.save(st, "latest")
    p2 = m.save(st, "best_dice")
    assert os.stat(p1).st_ino == os.stat(p2).st_ino
    st2 = HostState(model={"w": torch.zeros(64, 64)}, optimizer={}, step=7)
    p3 = m.save(st2, "best_ncc")
    assert os.stat(p3).st_ino != os.stat(p1).st_ino  # another snapshot: a real write
    ckpt, step = m.read("best_ncc")
    assert step == 7 and float(ckpt["model"]["w"].sum()) == 0.0


def test_async_writes_drain_and_roundtrip(tmp_path, state):
    mgr = CheckpointManager(str(tmp_path), async_writes=True)
    host = host_snapshot(state)
    mgr.save(host, "latest", step=3)
    mgr.save(host, "best_dice", step=3)  # the same snapshot: hardlinked
    mgr.wait()
    assert mgr.latest_step("latest") == 3 and mgr.latest_step("best_dice") == 3
    assert (os.stat(tmp_path / "model.ckpt-3.pt").st_ino
            == os.stat(tmp_path / "model_best_dice.ckpt-3.pt").st_ino)
    fresh = create_train_state(CFG, device="cpu", seed=9)
    restored, step = mgr.restore(fresh, "latest")
    assert step == 3
    _same_state(restored, state)
    mgr.close()
    mgr.close()  # idempotent


def test_async_restore_waits_for_pending(tmp_path, state):
    mgr = CheckpointManager(str(tmp_path), async_writes=True)
    mgr.save(state, "latest", step=7)
    _, step = mgr.restore(create_train_state(CFG, device="cpu"), "latest")  # no wait()
    assert step == 7


def test_async_save_then_in_place_update_keeps_the_saved_values(tmp_path, state):
    """The port's step updates the parameters in place, so a save must copy
    them when it is called: steps taken while the write is queued do not
    reach the file."""
    mgr = CheckpointManager(str(tmp_path), async_writes=True)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    adam_before = {k: v.clone() for k, v in state.optimizer.state_dict()["state"][0].items()}
    gate = __import__("threading").Event()
    mgr.submit(gate.wait)  # hold the writer until the state has moved on
    mgr.save(state, "latest")
    step = make_train_step(CFG)
    g = torch.Generator().manual_seed(1)
    step(state, torch.randn(2, 16, 16, 1, generator=g),
         torch.randint(0, 2, (2, 16, 16), generator=g), g)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    gate.set()
    ckpt, saved_step = mgr.read("latest")
    assert saved_step == 2 and ckpt["step"] == 2
    for k, v in before.items():
        assert torch.equal(ckpt["model"][k], v), k
    for k, v in adam_before.items():
        assert torch.equal(ckpt["optimizer"]["state"][0][k], v), k


def test_async_worker_error_surfaces(tmp_path, state):
    mgr = CheckpointManager(str(tmp_path), async_writes=True)
    mgr.save(state, "latest", step=1)
    mgr.wait()

    def boom(*a, **k):
        raise OSError("disk full")

    mgr._save_sync = boom  # a failure of the writer is not swallowed
    mgr.save(state, "latest", step=2)
    with pytest.raises(OSError):
        mgr.wait()
    mgr.save(state, "latest", step=3)
    with pytest.raises(OSError):
        mgr.close()
