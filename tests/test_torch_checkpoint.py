"""PyTorch port: checkpoints, resume, preemption, logging and the trainer CLI
of the training loop (``training.checkpoint``, ``training.loop``,
``utils.logging``, ``utils.profiling``), on the CPU at a tiny size.

A restored state must equal the saved one bit for bit, and a preempted run
resumed from its checkpoint must end bit-equal to the same run left
uninterrupted (the CPU's kernels are deterministic).  K steps a dispatch
against one agree within 1e-5 (the K-step loss is a mean, summed back).
"""

import dataclasses
import os
import signal
import sys
import threading

import pytest
import torch

from two_tower_models_tpu_torch import config as tcfg
from two_tower_models_tpu_torch.training import checkpoint as tckpt
from two_tower_models_tpu_torch.training import loop as tloop
from two_tower_models_tpu_torch.training import state as tstate
from two_tower_models_tpu_torch.training import step as tstep
from two_tower_models_tpu_torch.training.data import make_synthetic_data
from two_tower_models_tpu_torch.utils.logging import JsonlLogger
from two_tower_models_tpu_torch.utils.profiling import annotate

MODEL = tcfg.preset(
    "two_tower_with_debiasing", user_id_hash_size=64, item_id_hash_size=64,
    user_id_embedding_dim=16, item_id_embedding_dim=16, user_features_size=8,
    item_features_size=8, feature_hidden_dim=32, history_len=4,
    history_encoder=tcfg.HistoryEncoderConfig(num_heads=2, num_layers=1),
    user_value_weights=(1.0, 0.5), debias_aux_weight=1.0 / 32,
)
DATA = tcfg.DataConfig(num_samples=256, num_users=64, num_items=64, feature_dim=8,
                       history_len=4, num_tasks=2)
TRAIN = tcfg.TrainConfig(batch_size=32, num_epochs=2, log_every=0, seed=3)


@pytest.fixture(autouse=True)
def _keep_sigterm_handler():
    """``main`` installs the preemption handler; give the process its own
    back after each test."""
    prev = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, prev)


def _exp(**train):
    return tcfg.ExperimentConfig(model=MODEL, data=DATA, train=dataclasses.replace(TRAIN, **train))


class Recorder(JsonlLogger):
    def __init__(self, **kw):
        super().__init__(echo=False, **kw)
        self.events = []

    def log(self, event, **fields):
        self.events.append((event, fields))
        super().log(event, **fields)


def _tensors(state):
    return {k: v.detach().clone() for k, v in tckpt.state_tensors(state).items()}


def _assert_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def _trained_state(train_cfg, seed=0, steps=2):
    cfg = tcfg.resolve_kernel_flags(MODEL, "cpu")
    state = tstate.create_train_state(seed, cfg, train_cfg, device="cpu")
    data = make_synthetic_data(DATA, label_cols=cfg.num_tasks, device="cpu")
    step = tstep.make_train_step(cfg, train_cfg)
    with torch.enable_grad():
        for i in range(steps):
            state, _ = step(state, data, torch.arange(i * 32, (i + 1) * 32))
    return state, step, data


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("lazy", [False, True], ids=["adam", "lazy-packed"])
def test_round_trip(tmp_path, async_save, lazy):
    """Save, then restore into a fresh template: every tensor bit-equal, the
    template's parameters the same objects.  The lazy case packs both
    tables ([V/P, 128] storage) and keeps their moments in LazyAdamState."""
    tc = dataclasses.replace(TRAIN, lazy_table_adam=lazy, pack_tables_min_rows=64)
    state, _, _ = _trained_state(tc)
    if lazy:
        assert isinstance(state.opt_state, tstate.LazyAdamState)
        assert state.params.item_id_table.shape == (8, 128)
    want = _tensors(state)
    mgr = tckpt.CheckpointManager(str(tmp_path), async_save=async_save, device="cpu")
    assert mgr.save(state) is True
    mgr.wait_until_finished()
    assert mgr.all_steps() == [2]
    template = tstate.create_train_state(9, tcfg.resolve_kernel_flags(MODEL, "cpu"), tc,
                                         device="cpu")
    params_before = list(template.params.parameters())
    restored = mgr.restore_latest(template)
    mgr.close()
    assert restored is template
    assert all(a is b for a, b in zip(restored.params.parameters(), params_before))
    _assert_equal(_tensors(restored), want)


def test_restore_rejects_another_state(tmp_path):
    state, _, _ = _trained_state(TRAIN)
    mgr = tckpt.CheckpointManager(str(tmp_path), async_save=False, device="cpu")
    assert mgr.restore_latest(state) is None  # nothing saved yet
    mgr.save(state)
    lazy = dataclasses.replace(TRAIN, lazy_table_adam=True)
    other = tstate.create_train_state(0, tcfg.resolve_kernel_flags(MODEL, "cpu"), lazy, device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        mgr.restore_latest(other)
    wider = dataclasses.replace(MODEL, feature_hidden_dim=48)
    other = tstate.create_train_state(0, tcfg.resolve_kernel_flags(wider, "cpu"), TRAIN, device="cpu")
    with pytest.raises(ValueError, match="template's"):
        mgr.restore_latest(other)


def test_max_to_keep_and_idempotent_save(tmp_path):
    state, step, data = _trained_state(TRAIN, steps=0)
    mgr = tckpt.CheckpointManager(str(tmp_path), max_to_keep=2, async_save=True, device="cpu")
    with torch.enable_grad():
        for i in range(5):
            state, _ = step(state, data, torch.arange(32))
            assert mgr.save(state) is True
            assert mgr.save(state, force=True) is False  # the step is already saved
    mgr.close()
    assert mgr.all_steps() == [4, 5]
    assert sorted(os.listdir(tmp_path)) == ["step_4.pt", "step_5.pt"]


def test_async_save_snapshots_before_in_place_steps(tmp_path):
    """The port's steps write params and moments in place: an async save
    followed at once by more steps must still restore the state as it was
    when save returned."""
    state, step, data = _trained_state(TRAIN, steps=1)
    want = _tensors(state)
    mgr = tckpt.CheckpointManager(str(tmp_path), async_save=True, device="cpu")
    mgr.save(state)
    with torch.enable_grad():
        for i in range(3):
            state, _ = step(state, data, torch.arange(32, 64))
    assert not torch.equal(state.params.item_id_table, want["params.item_id_table"])
    template = tstate.create_train_state(9, tcfg.resolve_kernel_flags(MODEL, "cpu"), TRAIN,
                                         device="cpu")
    _assert_equal(_tensors(mgr.restore_latest(template)), want)
    mgr.close()


def test_async_save_picks_mode_from_probe(tmp_path, monkeypatch):
    monkeypatch.setattr(tckpt, "_d2h_mbps_cache", {"cpu": 1.6})
    assert tckpt.CheckpointManager(str(tmp_path), device="cpu").async_save is False
    monkeypatch.setattr(tckpt, "_d2h_mbps_cache", {"cpu": 8000.0})
    assert tckpt.CheckpointManager(str(tmp_path), device="cpu").async_save is True
    monkeypatch.setattr(tckpt, "_d2h_mbps_cache", {})
    assert tckpt.device_to_host_mbps("cpu") > 0


def test_resume_skips_completed_epochs(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    first = tloop.train(_exp(checkpoint_dir=ckpt), Recorder(), device="cpu")
    assert first["epoch_numbers"] == [0, 1]
    assert first["epoch_losses"][-1] < first["epoch_losses"][0]
    rec = Recorder()
    second = tloop.train(_exp(checkpoint_dir=ckpt, num_epochs=3), rec, device="cpu")
    events = dict(rec.events)
    assert events["restored"]["step"] == 16
    assert events["resume_skip"] == {"epochs": 2, "steps": 16}
    assert second["epoch_numbers"] == [2]
    assert int(second["state"].step) == 24
    assert second["recall_at_k"] is not None


def test_preempt_and_resume_match_an_uninterrupted_run(tmp_path):
    """A flag set mid-epoch: the loop saves, returns preempted, and the
    same call again restores, skips to the exact batch and ends bit-equal
    to the run that was never interrupted."""
    flag = threading.Event()

    class FlagAtStep5(Recorder):
        def log(self, event, **fields):
            if event == "step" and fields.get("step", 0) >= 5:
                flag.set()
            super().log(event, **fields)

    exp = _exp(checkpoint_dir=str(tmp_path / "ckpt"), log_every=1)
    rec = FlagAtStep5()
    s1 = tloop.train(exp, rec, preempt_flag=flag, device="cpu")
    assert s1["preempted"] is True and s1["recall_at_k"] is None
    assert int(s1["state"].step) == 5
    assert ("preempted", {"step": 5, "epoch": 0}) in rec.events
    rec2 = Recorder()
    s2 = tloop.train(exp, rec2, device="cpu")
    assert dict(rec2.events)["restored"]["step"] == 5
    assert s2["preempted"] is False and s2["epoch_numbers"] == [0, 1]
    whole = tloop.train(_exp(log_every=1), Recorder(), device="cpu")
    _assert_equal(_tensors(s2["state"]), _tensors(whole["state"]))
    assert s2["recall_at_k"] == whole["recall_at_k"]
    assert s2["epoch_losses"][1] == whole["epoch_losses"][1]


def test_steps_per_dispatch_with_remainder_matches_single_steps():
    """K = 3 over 10 batches an epoch: three 3-step dispatches, then one
    single step, against ten single steps."""
    data = dataclasses.replace(DATA, num_samples=320)
    runs = [tloop.train(dataclasses.replace(_exp(steps_per_dispatch=k), data=data),
                        Recorder(), device="cpu") for k in (1, 3)]
    (a, b) = runs
    assert int(a["state"].step) == int(b["state"].step) == 20
    torch.testing.assert_close(torch.tensor(b["epoch_losses"]), torch.tensor(a["epoch_losses"]),
                               rtol=1e-5, atol=0)
    for k, want in tckpt.state_tensors(a["state"]).items():
        got = tckpt.state_tensors(b["state"])[k]
        scale = max(float(want.abs().max()), 1e-30)
        assert float((got - want).abs().max()) <= 1e-5 * scale, k


def test_profile_dir_writes_a_trace(tmp_path):
    rec = Recorder()
    with annotate("train"):
        tloop.train(_exp(profile_dir=str(tmp_path), num_epochs=1), rec, device="cpu")
    assert [e for e, _ in rec.events].count("profile_written") == 1
    traces = [f for f in os.listdir(tmp_path) if f.startswith("trace_")]
    assert len(traces) == 1 and os.path.getsize(tmp_path / traces[0]) > 0


def test_debug_nans_raises_and_restores_anomaly_mode():
    assert not torch.is_anomaly_enabled()
    with pytest.raises((FloatingPointError, RuntimeError), match="(?i)nan|non-finite"):
        tloop.train(_exp(debug_nans=True, learning_rate=float("nan")), Recorder(), device="cpu")
    assert not torch.is_anomaly_enabled()


def test_sigterm_sets_the_flag():
    flag = tloop.install_preemption_handler()
    assert not flag.is_set()
    os.kill(os.getpid(), signal.SIGTERM)
    assert flag.wait(timeout=5)


def test_tensorboard_mirror(tmp_path, monkeypatch):
    """Scalars mirror at the record's step, step-less events at the last
    step logged; a bool mirrors as 0.0 or 1.0 (it is logged as a float, as
    the JAX logger logs it), a string not at all.  A real event file is
    written; without tensorboardX the logger raises, naming the flag."""
    import tensorboardX

    calls = []

    class Writer:
        def __init__(self, logdir):
            self.logdir = logdir

        def add_scalar(self, tag, value, step):
            calls.append((tag, value, step))

        def close(self):
            calls.append("closed")

    log = JsonlLogger(echo=False, tensorboard_dir=str(tmp_path / "real"))
    log.log_metrics("step", {"loss": torch.tensor(0.5)}, step=3)
    log.close()
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(tmp_path / "real"))

    monkeypatch.setattr(tensorboardX, "SummaryWriter", Writer)
    log = JsonlLogger(echo=False, tensorboard_dir=str(tmp_path / "tb"))
    log.log_metrics("step", {"loss": torch.tensor(0.5), "grad_norm": torch.tensor(2.0)},
                    epoch=0, step=10)
    log.log("eval", recall_at_k=0.25, top_k=100, flag=True, name="x")
    log.log("epoch", step=20, avg_loss=1.5)
    log.close()
    assert calls == [
        ("step/loss", 0.5, 10), ("step/grad_norm", 2.0, 10), ("step/epoch", 0.0, 10),
        ("eval/recall_at_k", 0.25, 10), ("eval/top_k", 100.0, 10), ("eval/flag", 1.0, 10),
        ("epoch/avg_loss", 1.5, 20), "closed",
    ]

    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    with pytest.raises(ImportError, match="tensorboard_dir"):
        JsonlLogger(echo=False, tensorboard_dir=str(tmp_path / "none"))


def test_log_metrics_reads_tensors_and_writes_jsonl(tmp_path):
    path = tmp_path / "log.jsonl"
    log = JsonlLogger(str(path), echo=False)
    log.log_metrics("step", {"loss": torch.tensor(0.25), "n": torch.tensor(3)}, step=7)
    log.close()
    import json

    rec = json.loads(path.read_text())
    assert rec["event"] == "step" and rec["loss"] == 0.25 and rec["n"] == 3.0
    assert rec["step"] == 7 and "t" in rec


def test_main_prints_epochs_and_recall(tmp_path, capsys):
    argv = ["--preset", "two_tower_with_user_history_encoder", "--num_epochs", "2",
            "--num_samples", "128", "--embedding_dim", "16", "--user_history_seqlen", "4",
            "--checkpoint_dir", str(tmp_path), "--device", "cpu"]
    tloop.main(argv)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("Epoch [1/2] - Loss: ")
    assert out[1].startswith("Epoch [2/2] - Loss: ")
    assert out[2].startswith("recall@100: ")
    summary = tloop.main(argv[:3] + ["3"] + argv[4:])
    assert summary["epoch_numbers"] == [2]
    assert capsys.readouterr().out.splitlines()[0].startswith("Epoch [3/3] - Loss: ")


def test_mesh_and_multihost_raise():
    exp = dataclasses.replace(_exp(), mesh=tcfg.MeshConfig(data=2))
    with pytest.raises(NotImplementedError, match="Multi-device"):
        tloop.train(exp, Recorder(), device="cpu")
    with pytest.raises(NotImplementedError, match="Multi-device"):
        tloop.main(["--multihost", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="Multi-device"):
        tloop.main(["--mesh_model", "4", "--device", "cpu"])


def test_mixed_negatives_and_streaming_logq_resume_exactly(tmp_path):
    """``tloop.train`` with 8 mixed negatives and the streaming logQ
    estimator: one epoch with a checkpoint directory, then the same call for
    two epochs resumes from it and ends bit-equal to two epochs run
    uninterrupted, the negatives' generator and the estimator included."""
    model = dataclasses.replace(MODEL, mixed_negatives=8, logq_correction=True)
    exp = lambda ckpt, epochs: dataclasses.replace(
        _exp(num_epochs=epochs, streaming_logq=True, checkpoint_dir=ckpt), model=model)
    want = tloop.train(exp(None, 2), Recorder(), device="cpu")
    first = tloop.train(exp(str(tmp_path), 1), Recorder(), device="cpu")
    assert first["epoch_numbers"] == [0]
    rec = Recorder()
    got = tloop.train(exp(str(tmp_path), 2), rec, device="cpu")
    assert [f["step"] for e, f in rec.events if e == "restored"] == [8]
    assert got["epoch_numbers"] == [1] and got["epoch_losses"][0] == want["epoch_losses"][1]
    assert {"rng", "logq.counts", "logq.total"} <= tckpt.state_tensors(got["state"]).keys()
    _assert_equal(_tensors(got["state"]), _tensors(want["state"]))


def test_train_and_serve_example(tmp_path, capsys):
    """examples/train_and_serve_torch.py on the CPU: train, resume one
    epoch from the checkpoint, serve 16 queries."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "examples" / "train_and_serve_torch.py"
    spec = importlib.util.spec_from_file_location("train_and_serve_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.main(["--device", "cpu", "--workdir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("trained 2 epochs: loss ")
    assert out[1].startswith("resumed epoch 3: loss ")
    assert out[2].startswith("served 16 queries -> top-50 indices, shape (16, 50)")
    assert out[3].startswith("affinity-group rate in retrieved items: ")
