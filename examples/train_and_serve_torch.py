"""End-to-end lifecycle with the PyTorch port: train -> checkpoint -> resume
-> build corpus -> serve.

The port's counterpart of ``examples/train_and_serve.py``: the same demo
configuration and the same story, through ``two_tower_models_tpu_torch``.
Runs on an NVIDIA GPU (default) or the CPU:

    python examples/train_and_serve_torch.py [--workdir /tmp/two_tower_demo_torch] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from two_tower_models_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    TrainConfig,
    preset,
)
from two_tower_models_tpu_torch.serving import RetrievalEngine
from two_tower_models_tpu_torch.training.data import make_synthetic_data
from two_tower_models_tpu_torch.training.loop import train
from two_tower_models_tpu_torch.utils.logging import JsonlLogger


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="/tmp/two_tower_demo_torch")
    ap.add_argument("--keep", action="store_true",
                    help="keep an existing workdir (default: start fresh so "
                         "the train->resume story replays)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    ckpt_dir = os.path.join(args.workdir, "ckpt")
    if not args.keep and os.path.exists(ckpt_dir):
        print(f"removing stale demo checkpoints at {ckpt_dir}")
        shutil.rmtree(ckpt_dir)

    # 1. Configure: the history-encoder + combined-debias variant at demo
    #    scale.  `preset` accepts any reference class name.
    model = preset(
        "two_tower_with_debiasing",
        history_len=8,
        user_id_hash_size=512,
        item_id_hash_size=512,
        user_id_embedding_dim=32,
        item_id_embedding_dim=32,
        num_items=50,
        # The reference's debias aux MSEs are batch sums; rescale so they
        # do not drown the retrieval loss (BASELINE.md's large-batch note).
        debias_aux_weight=1.0 / 64,
    )
    data_cfg = DataConfig(
        num_samples=4096, num_users=512, num_items=512,
        feature_dim=8, history_len=8, num_tasks=model.num_tasks,
    )

    # 2. Train 2 epochs with periodic checkpoints.
    def experiment(epochs):
        return ExperimentConfig(
            model=model, data=data_cfg,
            train=TrainConfig(
                batch_size=64, num_epochs=epochs, learning_rate=1e-3,
                checkpoint_dir=ckpt_dir, log_every=0,
            ),
        )

    first = train(experiment(2), JsonlLogger(echo=False), device=args.device)
    print(f"trained 2 epochs: loss {first['epoch_losses'][0]:.4f} -> "
          f"{first['epoch_losses'][-1]:.4f}, recall@100 {first['recall_at_k']:.3f}")

    # 3. Resume: same checkpoint dir, one more epoch — completed epochs skip.
    resumed = train(experiment(3), JsonlLogger(echo=False), device=args.device)
    print(f"resumed epoch {resumed['epoch_numbers'][0] + 1}: "
          f"loss {resumed['final_loss']:.4f}, recall@100 {resumed['recall_at_k']:.3f}")

    # 4. Serve: build the corpus from the trained item tower and retrieve
    #    for a batch of users.
    params = resumed["state"].params
    data = make_synthetic_data(data_cfg, label_cols=model.num_tasks, device=args.device)
    engine = RetrievalEngine.from_params(
        params, model, data.catalog_ids, data.catalog_features, device=args.device
    )
    with torch.no_grad():
        engine.warmup(batch_size=16)
        top = engine.query(
            data.user_ids[:16], data.user_features[:16], data.user_history[:16]
        )
    print(f"served 16 queries -> top-{model.num_items} indices, "
          f"shape {tuple(top.shape)}, sample row 0: {torch.sort(top[0]).values[:8].tolist()}...")

    # 5. The affinity check: retrieved items should over-represent each
    #    user's affinity group (user_id % 8 == item_id % 8 in the synthetic
    #    generator) relative to the 1/8 base rate.
    match = (top % 8 == (data.user_ids[:16] % 8)[:, None]).float().mean()
    print(f"affinity-group rate in retrieved items: {float(match):.3f} "
          f"(random would be 0.125)")


if __name__ == "__main__":
    main()
