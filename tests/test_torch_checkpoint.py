"""The port's checkpoints (`training/checkpoint.py`) and the Trainer's
save and restore, modelled on the JAX package's checkpoint tests in
`tests/unit/test_resilience.py` and `test_async_host_loop.py`: the
`<dir>/<step>` + `<step>.meta.json` layout, the content digest (a
tampered or truncated checkpoint raises the typed `CheckpointCorrupt`),
a missing sidecar, quarantine, async saves equal to sync ones and
snapshotted before they return, a same-path re-save, `weights_only`
loading, and the full train state (parameters, optimizer state and
update count, step, EMA, accumulation buffers) coming back bit for bit.
Port-only: bit-equality throughout, no tolerance.
"""

import fractions
import os
import threading

import numpy as np
import pytest
import torch

from cloud_tpu_torch.models import TransformerLM
from cloud_tpu_torch.training import checkpoint as ckpt
from cloud_tpu_torch.training import resilience
from cloud_tpu_torch.training import trainer as ttrainer

CFG = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=64, d_ff=128,
           max_seq_len=32)


def _state():
    return {"w": torch.arange(16, dtype=torch.float32),
            "b": torch.ones(4, dtype=torch.bfloat16),
            "meta": {"n": 3, "name": "x", "pair": (1, 2.5), "none": None}}


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            _equal(x, y) for x, y in zip(a, b))
    return a == b


def _largest_file(root):
    files = [os.path.join(r, n) for r, _, names in os.walk(root)
             for n in names]
    return max(files, key=os.path.getsize)


def test_layout_sidecar_and_round_trip(tmp_path):
    data_state = {"epoch": 1, "step_in_epoch": 3, "dataset_epoch": 2,
                  "data_seed": 7}
    path = ckpt.save(str(tmp_path), _state(), step=5, data_state=data_state)
    assert path == str(tmp_path / "5")
    assert os.path.isfile(tmp_path / "5" / "state.pt")
    meta = ckpt.load_metadata(str(tmp_path), 5)
    assert meta["step"] == 5 and meta["data_state"] == data_state
    assert meta["digest"] == ckpt.tree_digest(_state())
    assert ckpt.latest_step(str(tmp_path)) == 5   # sidecars are skipped
    assert _equal(ckpt.restore(str(tmp_path)), _state())
    assert ckpt.latest_step(str(tmp_path / "missing")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "missing"))


def test_digest_tamper_raises_typed_corrupt(tmp_path):
    ckpt.save(str(tmp_path), _state(), step=5)
    tree = torch.load(tmp_path / "5" / "state.pt", weights_only=True)
    tree["w"][3] += 1.0          # a well-formed file with other bytes
    torch.save(tree, tmp_path / "5" / "state.pt")
    with pytest.raises(resilience.CheckpointCorrupt, match="digest") as info:
        ckpt.restore(str(tmp_path), _state())
    assert info.value.step == 5
    assert _equal(ckpt.restore(str(tmp_path), verify=False)["w"], tree["w"])


def test_truncated_file_raises_typed_corrupt(tmp_path):
    ckpt.save(str(tmp_path), _state(), step=2)
    target = _largest_file(tmp_path / "2")
    with open(target, "r+b") as f:
        f.truncate(os.path.getsize(target) // 2)
    with pytest.raises(resilience.CheckpointCorrupt, match="failed to load"):
        ckpt.restore(str(tmp_path))


def test_code_in_a_checkpoint_is_refused(tmp_path):
    """`weights_only` loading: a pickle that would build an arbitrary
    object is refused, as a corrupt checkpoint."""
    os.makedirs(tmp_path / "1")
    torch.save({"w": fractions.Fraction(1, 3)}, tmp_path / "1" / "state.pt")
    with pytest.raises(resilience.CheckpointCorrupt):
        ckpt.restore(str(tmp_path), verify=False)


def test_missing_sidecar_restores_unverified(tmp_path):
    ckpt.save(str(tmp_path), _state(), step=1)
    os.remove(tmp_path / "1.meta.json")
    assert ckpt.load_metadata(str(tmp_path), 1) is None
    assert _equal(ckpt.restore(str(tmp_path)), _state())


def test_quarantine_falls_back_to_previous(tmp_path):
    ckpt.save(str(tmp_path), _state(), step=2)
    ckpt.save(str(tmp_path), _state(), step=4)
    moved = ckpt.quarantine(str(tmp_path), 4)
    assert moved.endswith("4.corrupt")
    assert ckpt.latest_step(str(tmp_path)) == 2
    assert os.path.exists(tmp_path / "4.corrupt.meta.json")
    assert ckpt.quarantine(str(tmp_path), 9) is None


def test_force_false_refuses_to_overwrite(tmp_path):
    ckpt.save(str(tmp_path), _state(), step=3)
    with pytest.raises(FileExistsError):
        ckpt.save(str(tmp_path), _state(), step=3, force=False)


def test_restore_into_a_target_tree(tmp_path):
    ckpt.save(str(tmp_path), {"w": torch.ones(3)}, step=0)
    got = ckpt.restore(str(tmp_path), {"w": torch.zeros(3)})
    assert torch.equal(got["w"], torch.ones(3))
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), {"w": torch.zeros(4)})
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), {"v": torch.zeros(3)})


def test_async_save_equals_sync_and_snapshots_first(tmp_path, monkeypatch):
    """The async save returns before its write (held here until
    released), having snapshotted the tensors: an in-place update after
    it returns does not reach the file, which equals a sync save's."""
    state = _state()
    ckpt.save(str(tmp_path / "sync"), state, step=7)
    release = threading.Event()
    write = ckpt._write_state

    def held_write(path, snapshot):
        assert release.wait(10)
        write(path, snapshot)

    monkeypatch.setattr(ckpt, "_write_state", held_write)
    path = ckpt.save(str(tmp_path / "async"), state, step=7, use_async=True)
    assert ckpt.pending_saves() == frozenset({path})
    assert not os.path.exists(os.path.join(path, ckpt.STATE_FILE))
    state["w"].add_(100.0)       # the next optimizer step, in place
    release.set()
    ckpt.wait_until_finished()
    assert ckpt.pending_saves() == frozenset()
    restored = ckpt.restore(str(tmp_path / "async"))
    assert _equal(restored, ckpt.restore(str(tmp_path / "sync")))
    assert (ckpt.load_metadata(str(tmp_path / "async"), 7)["digest"]
            == ckpt.load_metadata(str(tmp_path / "sync"), 7)["digest"])


def test_same_path_resave_completes_whole(tmp_path):
    for value in (1.0, 2.0, 3.0):
        ckpt.save(str(tmp_path), {"w": torch.full((1000,), value)},
                  step=4, use_async=True)
    ckpt.wait_until_finished()
    assert torch.equal(ckpt.restore(str(tmp_path))["w"],
                       torch.full((1000,), 3.0))


def test_background_write_error_surfaces(tmp_path, monkeypatch):
    def boom(path, snapshot):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_write_state", boom)
    ckpt.save(str(tmp_path), _state(), step=1, use_async=True)
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait_until_finished()
    assert ckpt.pending_saves() == frozenset()


def _trainer(**kw):
    model = TransformerLM(compute_dtype=torch.float32, device="cpu", seed=0,
                          **CFG)
    return ttrainer.Trainer(model, optimizer="adamw", seed=3, **kw)


def _data(n=16, seq=16):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, CFG["vocab_size"], size=(n, seq + 1))
    return tokens[:, :-1], tokens[:, 1:]


def test_trainer_state_round_trips_bit_for_bit(tmp_path):
    """Saved mid-accumulation (step 5 of windows of 2): the parameters,
    AdamW's state and update count, the step, the EMA shadow and the
    half-built gradient come back into a fresh Trainer, whose next step
    then equals the original's."""
    x, y = _data()
    kw = dict(ema_decay=0.9, gradient_accumulation_steps=2)
    a = _trainer(**kw)
    a.fit(x[:12], y[:12], epochs=1, batch_size=4, verbose=False)
    a.fit(x[12:], y[12:], epochs=1, batch_size=2, steps_per_epoch=2,
          verbose=False)
    assert a.state.step == 5 and a.state.updates == 2
    a.save_checkpoint(str(tmp_path), use_async=True)
    b = _trainer(**kw)
    b.restore_checkpoint(str(tmp_path))
    assert b.state.step == 5 and b.state.updates == 2
    assert _equal(b.state.state_dict(), a.state.state_dict())
    assert any(p.grad is not None for p in b.model.parameters())
    batch = (x[:4], y[:4])
    for trainer in (a, b):
        trainer._train_step(batch, False)
    assert _equal(b.state.state_dict(), a.state.state_dict())
    assert b.state.updates == 3


def test_restore_refuses_another_trainable_set(tmp_path):
    x, y = _data()
    a = _trainer(trainable="lm_head")
    a.fit(x, y, epochs=1, batch_size=8, verbose=False)
    a.save_checkpoint(str(tmp_path))
    with pytest.raises(ValueError, match="optimizer covers"):
        _trainer().restore_checkpoint(str(tmp_path))
    with pytest.raises(ValueError, match="EMA"):
        _trainer(trainable="lm_head", ema_decay=0.5).restore_checkpoint(
            str(tmp_path))
