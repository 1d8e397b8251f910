"""Host-side ingest: raw entity keys -> table slots.

The port's counterpart of the JAX package's ``training/ingest.py``, with the
same seeds and the same dispatch, so both packages map a key to the same
slot.  The reference assumes pre-hashed integer ids: every constructor takes
``*_hash_size`` (two_tower_base_retrieval.py:58-63), but nothing produces
the hashes.  Real feeds carry raw entity keys (64-bit surrogate ids or
strings); this module is that step, on the host's C++ batch hasher
(``native.hash_ids`` / ``native.hash_strings``, numpy fallback).  It returns
numpy int32 arrays; the caller moves them to the device.

Seeds are FIXED PER TABLE (user vs item) so the same raw key always lands on
the same slot across processes, restarts, and train/serve boundaries:
checkpointed embedding tables are only meaningful under a stable key->slot
map.  History keys hash with the ITEM seed: history ids embed through the
item table (two_tower_with_user_history_encoder.py:105).
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np

from two_tower_models_tpu_torch.config import ModelConfig
from two_tower_models_tpu_torch.native import hash_ids, hash_strings

# Stable per-table seeds: decorrelate the two tables' slot maps so a user
# key and an item key with equal raw value don't collide systematically.
USER_TABLE_SEED = 0xA11CE
ITEM_TABLE_SEED = 0xB0B

RawKeys = Union[np.ndarray, Sequence[Union[int, str, bytes]]]


def _hash_any(keys: RawKeys, table_size: int, seed: int) -> np.ndarray:
    """Dispatch on key kind: integer arrays take the uint64 path, strings /
    bytes the variable-length path.  Returns int32 slots, input shape."""
    arr = np.asarray(keys)
    if arr.dtype.kind in ("i", "u"):
        return hash_ids(arr, table_size, seed=seed)
    if arr.dtype.kind == "O":
        # Object arrays (pandas nullable columns, Python ints > int64) hold
        # ints OR strings; ints must take the uint64 path: bytes(int) would
        # allocate k zero bytes and hash only the magnitude.
        flat = arr.reshape(-1)
        if all(isinstance(k, int) for k in flat):
            u64 = np.array([k % (1 << 64) for k in flat], np.uint64)
            return hash_ids(u64, table_size, seed=seed).reshape(arr.shape)
        if not all(isinstance(k, (str, bytes)) for k in flat):
            raise TypeError("object-dtype raw keys must be all ints or all str/bytes")
        return hash_strings(list(flat), table_size, seed=seed).reshape(arr.shape)
    if arr.dtype.kind in ("U", "S"):
        return hash_strings(list(arr.reshape(-1)), table_size, seed=seed).reshape(arr.shape)
    raise TypeError(f"unsupported raw-key dtype {arr.dtype}")


def hash_user_keys(keys: RawKeys, cfg: ModelConfig) -> np.ndarray:
    """Raw user keys -> user-table slots (int32, the keys' shape)."""
    return _hash_any(keys, cfg.user_id_hash_size, USER_TABLE_SEED)


def hash_item_keys(keys: RawKeys, cfg: ModelConfig) -> np.ndarray:
    """Raw item keys (engaged items AND history entries) -> item-table
    slots (int32, the keys' shape)."""
    return _hash_any(keys, cfg.item_id_hash_size, ITEM_TABLE_SEED)


def ingest_example_keys(
    cfg: ModelConfig,
    user_keys: RawKeys,  # [B]
    item_keys: RawKeys,  # [B]
    history_keys: RawKeys,  # [B, H]
):
    """Hash one batch worth of raw keys -> (user_id, item_id, user_history)
    int32 numpy arrays, ready for ``models.two_tower.Batch`` once on the
    device."""
    return (
        hash_user_keys(user_keys, cfg),
        hash_item_keys(item_keys, cfg),
        hash_item_keys(history_keys, cfg),
    )
