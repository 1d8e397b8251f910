"""PyTorch port: package hygiene, the config mirror, the weight bridge and
the device rule of its entry points (CPU only)."""

import ast
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from two_tower_models_tpu import config as jcfg
from two_tower_models_tpu.models import two_tower as jtt
from two_tower_models_tpu_torch import bridge
from two_tower_models_tpu_torch import config as tcfg
from two_tower_models_tpu_torch.models import two_tower as ttt
from two_tower_models_tpu_torch.serving import RetrievalEngine

PORT = Path(__file__).resolve().parent.parent / "two_tower_models_tpu_torch"
CHIP_SMOKE = PORT.parent / "chip_smoke.py"
# runs on the GPU machine, which has no JAX
CUDA_TESTS = PORT.parent / "tests" / "test_torch_cuda_kernels.py"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [CHIP_SMOKE, CUDA_TESTS], ids=lambda p: p.name
)
def test_port_imports_no_jax(path):
    """Neither the port, nor chip_smoke.py, nor the GPU tests import JAX or
    the JAX package."""
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "two_tower_models_tpu", "optax"), (path, mod)


@pytest.mark.parametrize(
    "name", ["HistoryEncoderConfig", "LightRankerConfig", "ModelConfig"]
)
def test_config_mirrors_jax_fields(name):
    jf = {f.name: f.default for f in dataclasses.fields(getattr(jcfg, name))}
    tf = {f.name: f.default for f in dataclasses.fields(getattr(tcfg, name))}
    assert jf == tf
    assert tcfg.PRESET_NAMES == jcfg.PRESET_NAMES
    assert tcfg.Debias.ALL == jcfg.Debias.ALL


@pytest.mark.parametrize("preset", jcfg.PRESET_NAMES)
def test_bridge_round_trip_all_presets(preset):
    """JAX init_params -> numpy -> port -> numpy is bit-equal, and the port's
    own init builds the same leaves with the same shapes."""
    cfg_j = jcfg.preset(preset)
    params = jtt.init_params(jax.random.key(3), cfg_j)
    tree = jax.tree_util.tree_map(np.asarray, params)
    cfg_t = tcfg.preset(preset)
    model = bridge.params_from_jax(tree, cfg_t, device="cpu")
    back = bridge.params_to_jax(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    own = bridge.params_to_jax(ttt.init_params(0, cfg_t, device="cpu"))
    assert jax.tree_util.tree_map(np.shape, own) == jax.tree_util.tree_map(np.shape, tree)


def test_bridge_rejects_mismatched_tree():
    cfg = tcfg.preset("two_tower_base_retrieval")
    tree = bridge.params_to_jax(ttt.init_params(0, cfg, device="cpu"))
    tree["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError):
        bridge.params_from_jax(tree, cfg, device="cpu")


def test_init_distributions():
    """Tables N(0, 1), linear layers U(+-1/sqrt(fan_in)), attention biases 0."""
    cfg = tcfg.preset("two_tower_with_debiasing")
    m = ttt.init_params(7, cfg, device="cpu")
    t = m.item_id_table.detach()
    assert abs(float(t.mean())) < 0.05 and abs(float(t.std()) - 1) < 0.05
    w = m.user_features_mlp[0].w.detach()
    assert float(w.abs().max()) <= 1 / np.sqrt(w.shape[0])
    assert float(m.history_encoder.attn_layers[0].in_proj.b.abs().max()) == 0.0


def test_cuda_entry_points_raise_without_gpu(monkeypatch):
    """Without a GPU, an entry point that was not asked for the CPU raises
    rather than running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg.ModelConfig(user_id_hash_size=16, item_id_hash_size=64, history_len=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttt.init_params(0, cfg)
    model = ttt.init_params(0, cfg, device="cpu")
    corpus = torch.randn(64, cfg.item_id_embedding_dim)
    args = (torch.zeros(2, dtype=torch.long), torch.zeros(2, 8),
            torch.zeros(2, 4, dtype=torch.long))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttt.retrieve(model, cfg, corpus, *args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RetrievalEngine(model, cfg, corpus)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.params_from_jax(bridge.params_to_jax(model), cfg)
    assert ttt.retrieve(model, cfg, corpus, *args, device="cpu").shape == (2, 10)


def test_kernel_flags_resolve_on_device():
    cfg = tcfg.preset("two_tower_with_user_history_encoder")
    assert cfg.history_encoder.fused_encoder is None
    assert tcfg.resolve_kernel_flags(cfg, "cpu").history_encoder.fused_encoder is False
    on_gpu = tcfg.resolve_kernel_flags(cfg, "cuda")
    assert on_gpu.history_encoder.fused_encoder is True and on_gpu.fused_loss is True
    explicit = dataclasses.replace(
        cfg, history_encoder=tcfg.HistoryEncoderConfig(fused_encoder=False)
    )
    assert tcfg.resolve_kernel_flags(explicit, "cuda").history_encoder.fused_encoder is False


def test_unported_paths_raise():
    cfg = tcfg.ModelConfig(user_id_hash_size=16, item_id_hash_size=64, history_len=4)
    model = ttt.init_params(0, cfg, device="cpu")
    corpus = torch.randn(64, cfg.item_id_embedding_dim)
    args = (torch.zeros(2, dtype=torch.long), torch.zeros(2, 8),
            torch.zeros(2, 4, dtype=torch.long))
    with pytest.raises(NotImplementedError, match="approx_mips"):
        ttt.retrieve(model, dataclasses.replace(cfg, approx_mips=True), corpus, *args,
                     device="cpu")
    with pytest.raises(NotImplementedError, match="int8"):
        ttt.retrieve(model, cfg, corpus.numpy(), *args, device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        RetrievalEngine(model, cfg, corpus, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="int8"):
        RetrievalEngine(model, cfg, corpus, quantize="int8", device="cpu")
    lr = tcfg.preset("two_tower_plus_light_ranker", user_id_hash_size=16,
                     item_id_hash_size=64, history_len=4)
    lr_model = ttt.init_params(0, lr, device="cpu")
    with pytest.raises(NotImplementedError, match="light-ranker"):
        ttt.retrieve(lr_model, lr, corpus, *args, device="cpu")
