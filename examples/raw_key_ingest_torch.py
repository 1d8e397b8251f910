"""Raw-key ingest with the PyTorch port: string entity keys through the C++
hasher into training batches AND serving queries.

The port's counterpart of ``examples/raw_key_ingest.py``: an event log of
(user key, item key, history keys) strings feeds training through
``training.ingest`` (the host's C++ batch hash, numpy fallback), and the
SAME key->slot map serves raw-key queries through
``RetrievalEngine.query_raw``.  Runs on an NVIDIA GPU (default) or the CPU:

    python examples/raw_key_ingest_torch.py [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from two_tower_models_tpu_torch import native
from two_tower_models_tpu_torch.config import TrainConfig, preset, resolve_device
from two_tower_models_tpu_torch.serving import RetrievalEngine
from two_tower_models_tpu_torch.training.data import SyntheticRecData
from two_tower_models_tpu_torch.training.ingest import hash_item_keys, ingest_example_keys
from two_tower_models_tpu_torch.training.state import create_train_state
from two_tower_models_tpu_torch.training.step import make_train_step

N_USERS, N_ITEMS, H, B, STEPS = 256, 200, 8, 64, 60


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"native C++ hasher available: {native.native_available()}")
    model = preset(
        "two_tower_with_user_history_encoder",
        history_len=H,
        user_id_hash_size=512,
        item_id_hash_size=512,
        user_id_embedding_dim=32,
        item_id_embedding_dim=32,
        num_items=50,
    )

    # --- a raw event log: STRING keys, as a real feed would carry ---------
    rng = np.random.default_rng(0)
    user_names = np.array([f"user:{i:04d}@example.com" for i in range(N_USERS)])
    item_names = np.array([f"sku-{i:05d}" for i in range(N_ITEMS)])
    n_events = 4096
    ev_user = rng.integers(0, N_USERS, n_events)
    # 8-group affinity so recall is measurable (mirrors the synthetic data)
    ev_item = (rng.integers(0, N_ITEMS // 8, n_events) * 8 + ev_user % 8) % N_ITEMS
    ev_hist = (rng.integers(0, N_ITEMS // 8, (n_events, H)) * 8 + ev_user[:, None] % 8) % N_ITEMS

    # --- ingest: raw keys -> table slots (host-side C++ batch hash) -------
    uid, iid, hist = ingest_example_keys(
        model, user_names[ev_user], item_names[ev_item], item_names[ev_hist]
    )
    feats = rng.standard_normal((n_events, model.user_features_size)).astype(np.float32)
    ifeats = rng.standard_normal((n_events, model.item_features_size)).astype(np.float32)
    labels = np.ones((n_events, model.num_tasks), np.float32)
    pos = rng.integers(0, 10, n_events)
    catalog_feats = rng.standard_normal((N_ITEMS, model.item_features_size)).astype(np.float32)

    on = lambda a, dtype=None: torch.as_tensor(a, dtype=dtype, device=dev)
    data = SyntheticRecData(
        user_ids=on(uid), user_features=on(feats), user_history=on(hist), item_ids=on(iid),
        item_features=on(ifeats), positions=on(pos, torch.int32), labels=on(labels),
        catalog_ids=on(hash_item_keys(item_names, model)), catalog_features=on(catalog_feats),
    )

    # --- train on the ingested slots --------------------------------------
    tcfg = TrainConfig(batch_size=B, learning_rate=3e-3)
    state = create_train_state(0, model, tcfg, device=dev)
    step = make_train_step(model, tcfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    first = last = None
    for s in range(STEPS):
        idx = torch.randint(0, n_events, (B,), generator=gen, device=dev)
        state, metrics = step(state, data, idx)
        if s == 0:
            first = float(metrics["loss"])
    last = float(metrics["loss"])
    print(f"trained {STEPS} steps on ingested raw keys: loss {first:.3f} -> {last:.3f}")

    # --- serve by RAW key: same hash, same slots --------------------------
    engine = RetrievalEngine.from_params(
        state.params, model, data.catalog_ids, data.catalog_features, device=dev
    )
    q_users = user_names[ev_user[:16]]
    q_hist = item_names[ev_hist[:16]]
    top = engine.query_raw(q_users, data.user_features[:16], q_hist)
    print(f"served 16 raw-key queries -> shape {tuple(top.shape)}")

    # consistency: raw-key serving == serving with the ingested slots
    top_ids = engine.query(data.user_ids[:16], data.user_features[:16], data.user_history[:16])
    if not torch.equal(top, top_ids):
        raise SystemExit("raw-key path diverged from serving on the ingested slots")
    print("raw-key serving matches pre-hashed serving: OK")


if __name__ == "__main__":
    main()
