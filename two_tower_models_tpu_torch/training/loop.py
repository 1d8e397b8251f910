"""The training loop and its CLI.

Port of ``two_tower_models_tpu/training/loop.py`` for one device: epochs of
shuffled batches through ``make_train_step`` (with mixed negatives and the
logQ correction, oracle or streaming, when the config asks), the loss
summed on the device, corpus refresh and the recall@k eval, jsonl logging, checkpoints
with exact-position resume, SIGTERM preemption and a profiled window.
The loop on a mesh and across hosts is not ported (ROADMAP.md, queue A,
A13b, part 2, and A13d of A13 'Multi-device') and raises; the mesh's step
is (``parallel.train_step.make_sharded_train_step``).

Run:  python -m two_tower_models_tpu_torch.training.loop --preset two_tower_base_retrieval
      (add ``--device cpu`` on a machine without a GPU)
"""

from __future__ import annotations

import argparse
import contextlib
import signal
import threading
import time
from dataclasses import replace
from typing import Optional

import torch

from two_tower_models_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    MeshConfig,
    PRESET_NAMES,
    TrainConfig,
    check_single_device,
    preset,
    resolve_device,
    resolve_kernel_flags,
)
from two_tower_models_tpu_torch.retrieval.mips import refresh_corpus
from two_tower_models_tpu_torch.training.checkpoint import CheckpointManager
from two_tower_models_tpu_torch.training.data import gather_batch, make_synthetic_data
from two_tower_models_tpu_torch.training.state import create_train_state
from two_tower_models_tpu_torch.training.step import make_eval_recall_fn, make_train_step
from two_tower_models_tpu_torch.utils.logging import JsonlLogger
from two_tower_models_tpu_torch.utils.profiling import trace


def install_preemption_handler(
    flag: Optional[threading.Event] = None,
) -> threading.Event:
    """Route SIGTERM (the preemption notice of a preemptible or spot VM) to
    a flag the train loop checks at dispatch boundaries: the loop saves the
    state and returns instead of losing the epoch, and the next identical
    invocation resumes from the saved step."""
    flag = flag or threading.Event()

    def _handler(signum, frame):
        flag.set()

    signal.signal(signal.SIGTERM, _handler)
    return flag


def _hits_gate(every: int, global_step: int, executed: int) -> bool:
    """True if any step in this dispatch's covered range (global_step -
    executed, global_step] hits the every-N modulo: (g // every) increments
    across the range exactly when a multiple of ``every`` lies inside it."""
    return bool(every) and global_step // every > (global_step - executed) // every


def epoch_permutation(seed: int, epoch: int, num_samples: int, device) -> torch.Tensor:
    """Epoch ``epoch``'s batch order: a permutation of the samples from a
    generator seeded from ``(seed, epoch)`` alone, so a resumed run
    rebuilds it (never one generator carried across epochs)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed + 1) * 1_000_003 + epoch)
    return torch.randperm(num_samples, generator=gen, device=device)


def eval_indices(data_cfg: DataConfig, num_samples: int, device) -> torch.Tensor:
    """The eval's held-out sample: the first min(1024, n) of a permutation
    from ``data_cfg.seed + 100``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(data_cfg.seed + 100)
    return torch.randperm(num_samples, generator=gen, device=device)[: min(1024, num_samples)]


def train(
    exp: ExperimentConfig,
    logger: Optional[JsonlLogger] = None,
    preempt_flag: Optional[threading.Event] = None,
    device="cuda",
) -> dict:
    """Run the experiment on ``device``; returns the summary dict (epoch
    losses, recall, timings, the final state and corpus).

    ``preempt_flag``: optional event (see ``install_preemption_handler``);
    when set mid-training the loop checkpoints (if configured) and returns
    early with ``summary["preempted"] = True``.  ``debug_nans`` turns on
    autograd's anomaly mode (a backward that makes a NaN raises) and a
    finite check of each dispatch's loss and gradient norm, and restores
    the previous anomaly mode afterwards."""
    check_single_device(exp.mesh)
    logger = logger or JsonlLogger()
    dev = resolve_device(device)
    exp = replace(exp, model=resolve_kernel_flags(exp.model, dev))
    prev = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    if exp.train.debug_nans:
        torch.autograd.set_detect_anomaly(True, check_nan=True)
    try:
        return _train_inner(exp, logger, preempt_flag, dev)
    finally:
        if exp.train.debug_nans:
            torch.autograd.set_detect_anomaly(*prev)


def _summary(epoch_losses, recall, seconds, examples, state, corpus, preempted) -> dict:
    return {
        "epoch_losses": [l for _, l in epoch_losses],
        "epoch_numbers": [e for e, _ in epoch_losses],
        "final_loss": epoch_losses[-1][1] if epoch_losses else None,
        "recall_at_k": recall,
        "train_seconds": seconds,
        "examples_per_sec": examples / max(seconds, 1e-9),
        "state": state,
        "corpus": corpus,
        "preempted": preempted,
    }


def _train_inner(
    exp: ExperimentConfig,
    logger: JsonlLogger,
    preempt_flag: Optional[threading.Event],
    dev: torch.device,
) -> dict:
    model_cfg, train_cfg, data_cfg = exp.model, exp.train, exp.data

    label_cols = model_cfg.num_tasks * (2 if model_cfg.kd else 1)
    data = make_synthetic_data(
        data_cfg, structured=data_cfg.structured, label_cols=label_cols, device=dev
    )
    state = create_train_state(train_cfg.seed, model_cfg, train_cfg, device=dev,
                               catalog_size=data.catalog_ids.shape[0])

    # K steps a dispatch while they fit; the epoch's remainder runs as
    # single steps.
    k_dispatch = max(1, train_cfg.steps_per_dispatch)
    train_step = make_train_step(model_cfg, train_cfg)
    single_step = (
        make_train_step(model_cfg, replace(train_cfg, steps_per_dispatch=1))
        if k_dispatch > 1 else train_step
    )
    recall_fn = make_eval_recall_fn(model_cfg, train_cfg.eval_top_k)

    ckpt_mgr = None
    if train_cfg.checkpoint_dir:
        ckpt_mgr = CheckpointManager(train_cfg.checkpoint_dir, device=dev)
        restored = ckpt_mgr.restore_latest(state)
        if restored is not None:
            state = restored
            logger.log("restored", step=int(state.step))

    n_batches = data.num_samples // train_cfg.batch_size
    logger.log(
        "start",
        backend=dev.type,
        devices=1,
        num_batches_per_epoch=n_batches,
        num_params=sum(p.numel() for p in state.params.parameters()),
    )

    eval_idx = eval_indices(data_cfg, data.num_samples, dev)

    def eval_recall(params):
        """Refresh the corpus from the current item tower, then recall@k on
        the held-out sample: one number read back."""
        with torch.no_grad():
            corpus = refresh_corpus(params, model_cfg, data.catalog_ids, data.catalog_features)
            return corpus, float(recall_fn(params, corpus, gather_batch(data, eval_idx)))

    # Exact-position resume: the batch schedule is a pure function of
    # (seed, epoch), so the restored step count says which epochs are done
    # and how many leading batches of the current one to skip.
    start_step = int(state.step)
    start_epoch = min(start_step // n_batches, train_cfg.num_epochs)
    if start_epoch:
        logger.log("resume_skip", epochs=start_epoch, steps=start_step)

    def check_finite(metrics, global_step):
        bad = [k for k in ("loss", "grad_norm") if not bool(torch.isfinite(metrics[k]))]
        if bad:
            raise FloatingPointError(
                f"debug_nans: non-finite {' and '.join(bad)} in the dispatch ending at "
                f"step {global_step}"
            )

    epoch_losses = []
    t_train0 = time.monotonic()
    examples = 0
    bsz = train_cfg.batch_size
    for epoch in range(start_epoch, train_cfg.num_epochs):
        skip = start_step - epoch * n_batches if epoch == start_epoch else 0
        loss_sum = torch.zeros((), device=dev)  # stays on the device
        t0 = time.monotonic()
        n_run = 0
        perm = epoch_permutation(train_cfg.seed, epoch, data.num_samples, dev)
        with contextlib.ExitStack() as tracer, torch.enable_grad():
            profiling = False
            i = skip
            while i < n_batches:
                take = k_dispatch if i + k_dispatch <= n_batches else 1
                # Profile a post-warm-up window of epoch 0: the dispatches
                # covering steps 3-7.
                if (
                    train_cfg.profile_dir and epoch == 0
                    and not profiling and i <= 3 < i + take
                ):
                    tracer.enter_context(trace(train_cfg.profile_dir))
                    profiling = True
                if take > 1:
                    idx = perm[i * bsz : (i + take) * bsz].view(take, bsz)
                    state, metrics = train_step(state, data, idx)
                else:
                    state, metrics = single_step(state, data, perm[i * bsz : (i + 1) * bsz])
                loss_sum.add_(metrics["loss"].float(), alpha=take)
                n_run += take
                examples += take * bsz
                i += take
                # Host-side step counter: int(state.step) waits for the
                # device, so it is read only where a gate fires.
                global_step = epoch * n_batches + i
                if train_cfg.debug_nans:
                    check_finite(metrics, global_step)
                if profiling and i > 7:
                    tracer.close()  # synchronizes, then writes the trace
                    profiling = False
                    logger.log("profile_written", dir=train_cfg.profile_dir)
                gate = lambda every: _hits_gate(every, global_step, take)
                if gate(train_cfg.log_every):
                    logger.log_metrics("step", metrics, epoch=epoch, step=int(state.step))
                if gate(train_cfg.eval_every):
                    _, recall_mid = eval_recall(state.params)
                    logger.log(
                        "eval", step=global_step, recall_at_k=recall_mid,
                        top_k=train_cfg.eval_top_k,
                    )
                if ckpt_mgr and gate(train_cfg.checkpoint_every):
                    ckpt_mgr.save(state)
                if preempt_flag is not None and preempt_flag.is_set():
                    # A dispatch boundary is a consistent state: save it,
                    # land the write and return; the next identical call
                    # resumes from it.
                    if ckpt_mgr:
                        ckpt_mgr.save(state, force=True)
                        ckpt_mgr.close()
                    logger.log("preempted", step=int(state.step), epoch=epoch)
                    return _summary(epoch_losses, None, time.monotonic() - t_train0,
                                    examples, state, None, True)
        avg_loss = float(loss_sum) / max(n_run, 1)  # one sync an epoch
        epoch_losses.append((epoch, avg_loss))
        logger.log("epoch", epoch=epoch, avg_loss=avg_loss,
                   seconds=round(time.monotonic() - t0, 3))
    train_seconds = time.monotonic() - t_train0

    # Refresh the corpus from the trained item tower, then eval recall@k.
    corpus, recall = eval_recall(state.params)
    logger.log("eval", recall_at_k=recall, top_k=train_cfg.eval_top_k)

    if ckpt_mgr:
        ckpt_mgr.save(state, force=True)
        ckpt_mgr.close()
    return _summary(epoch_losses, recall, train_seconds, examples, state, corpus, False)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train a two-tower model with the PyTorch port")
    p.add_argument("--preset", choices=PRESET_NAMES, default="two_tower_base_retrieval")
    # the reference trainer's flags (train/train.py:186-254)
    p.add_argument("--num_users", type=int, default=100)
    p.add_argument("--num_items_to_return", type=int, default=10)
    p.add_argument("--user_id_hash_size", type=int, default=1024)
    p.add_argument("--item_id_hash_size", type=int, default=1024)
    p.add_argument("--user_history_seqlen", type=int, default=10)
    p.add_argument("--num_items", type=int, default=200)
    p.add_argument("--embedding_dim", type=int, default=32)
    p.add_argument("--feature_dim", type=int, default=8)
    p.add_argument("--num_samples", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--num_epochs", type=int, default=5)
    p.add_argument("--mixed_negatives", type=int, default=0,
                   help="extra uniformly-sampled catalog negatives per batch (MNS)")
    p.add_argument("--logq_correction", action="store_true",
                   help="subtract each candidate's log sampling probability from its logit (sampled-softmax correction)")
    p.add_argument("--streaming_logq", action="store_true",
                   help="estimate item frequencies online from the training "
                        "stream (decayed counts) instead of the synthetic "
                        "data's oracle catalog_logq")
    p.add_argument("--logq_decay", type=float, default=0.999,
                   help="streaming-estimator decay: effective window "
                        "~1/(1-decay) batches")
    p.add_argument("--popularity_skew", type=float, default=0.0,
                   help="Zipf exponent for synthetic item engagement (0 = uniform)")
    p.add_argument("--variable_history", action="store_true",
                   help="per-example history lengths in [1, H] (Batch.history_len "
                        "masks the encoder's mean/attention/PE)")
    p.add_argument("--noise_labels", action="store_true",
                   help="pure-noise labels like the reference demo (recall@k becomes random)")
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--grad_clip_norm", type=float, default=None,
                   help="global-norm gradient clip before Adam (off by "
                        "default = reference parity)")
    # systems flags the reference lacks
    p.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--log_file", default=None)
    p.add_argument("--tensorboard_dir", default=None, help="mirror scalar events to TensorBoard")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler Chrome trace of steps 3-7")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--debug_nans", action="store_true",
                   help="abort on the first NaN (autograd anomaly mode and a finite "
                        "check of each dispatch's loss and grad norm)")
    p.add_argument("--eval_every", type=int, default=0, help="mid-training recall@k every N steps")
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="K optimizer steps per dispatch")
    # mesh flags: parsed as the JAX trainer parses them; the port's loop
    # trains on one device, and a mesh of more raises (ROADMAP.md, A13b,
    # part 2, and A13d of A13 'Multi-device')
    p.add_argument("--mesh_data", type=int, default=1, help="data-parallel mesh axis")
    p.add_argument("--mesh_model", type=int, default=1, help="table-sharding mesh axis")
    p.add_argument("--tower_tp", action="store_true",
                   help="tensor-parallel feature MLPs over the model axis (Megatron split)")
    p.add_argument("--ring_negatives", action="store_true",
                   help="ring all-gather for the global-negative softmax")
    p.add_argument("--sparse_table_grads", choices=["auto", "on", "off"], default="auto",
                   help="cross-device table grads as dedup'd (ids, rows) instead "
                        "of a dense all-reduce")
    p.add_argument("--gspmd", action="store_true",
                   help="multi-device through the partitioner instead of explicit collectives")
    p.add_argument("--multihost", action="store_true",
                   help="initialize a multi-host run before building the mesh")
    p.add_argument("--device", default="cuda",
                   help="the device to train on: cuda (default) or cpu")
    return p


def config_from_args(args: argparse.Namespace) -> ExperimentConfig:
    model = preset(
        args.preset,
        num_items=args.num_items_to_return,
        user_id_hash_size=args.user_id_hash_size,
        user_id_embedding_dim=args.embedding_dim,
        user_features_size=args.feature_dim,
        item_id_hash_size=args.item_id_hash_size,
        item_id_embedding_dim=args.embedding_dim,
        item_features_size=args.feature_dim,
        history_len=args.user_history_seqlen,
        compute_dtype=args.compute_dtype,
        mixed_negatives=args.mixed_negatives,
        logq_correction=args.logq_correction,
    )
    data = DataConfig(
        num_samples=args.num_samples,
        num_users=args.num_users,
        num_items=args.num_items,
        feature_dim=args.feature_dim,
        history_len=args.user_history_seqlen,
        num_tasks=model.num_tasks,
        structured=not args.noise_labels,
        variable_history=args.variable_history,
        popularity_skew=args.popularity_skew,
    )
    train_c = TrainConfig(
        batch_size=args.batch_size,
        num_epochs=args.num_epochs,
        learning_rate=args.learning_rate,
        grad_clip_norm=args.grad_clip_norm,
        streaming_logq=args.streaming_logq,
        logq_decay=args.logq_decay,
        seed=args.seed,
        checkpoint_dir=args.checkpoint_dir,
        profile_dir=args.profile_dir,
        debug_nans=args.debug_nans,
        eval_every=args.eval_every,
        steps_per_dispatch=args.steps_per_dispatch,
    )
    mesh = MeshConfig(
        data=args.mesh_data, model=args.mesh_model,
        explicit_collectives=not args.gspmd,
        tower_tp=args.tower_tp,
        ring_negatives=args.ring_negatives,
        sparse_table_grads=args.sparse_table_grads,
    )
    return ExperimentConfig(model=model, data=data, train=train_c, mesh=mesh)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if args.multihost:
        raise NotImplementedError(
            "multi-host training is not ported yet "
            "(ROADMAP.md, queue A, A13d of A13 'Multi-device')"
        )
    exp = config_from_args(args)
    logger = JsonlLogger(args.log_file, tensorboard_dir=args.tensorboard_dir)
    preempt = install_preemption_handler()
    try:
        summary = train(exp, logger, preempt_flag=preempt, device=args.device)
    finally:
        logger.close()
    for epoch, loss in zip(summary["epoch_numbers"], summary["epoch_losses"]):
        print(f"Epoch [{epoch + 1}/{exp.train.num_epochs}] - Loss: {loss:.4f}")
    if summary.get("preempted"):
        print("preempted: state checkpointed; re-run to resume")
    else:
        print(f"recall@{exp.train.eval_top_k}: {summary['recall_at_k']:.4f}")
    return summary


if __name__ == "__main__":
    main()
