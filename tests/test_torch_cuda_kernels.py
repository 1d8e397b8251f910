"""PyTorch port: the four CUDA kernels against their plain PyTorch versions
on the card, at shapes the serving run does not reach (ragged corpora,
padded rows, odd batches, other encoder widths, hierarchical selects).

Needs an NVIDIA GPU with ``nvcc``; skips elsewhere.  It imports neither JAX
nor the JAX package, so on a machine without JAX run it without the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances: tile-max and rescore scores are f32 sums in another order than
cuBLAS's (rtol 1e-5); the encoder at 1e-4 (f32) and 3e-2 (bf16, three
layers of bf16 rounding); selections exactly.
"""

import math

import numpy as np
import pytest
import torch

from two_tower_models_tpu_torch.ops import _lib
from two_tower_models_tpu_torch.ops import fused_encoder as fe
from two_tower_models_tpu_torch.ops import mips_topk as mt
from two_tower_models_tpu_torch.retrieval.mips import mips_topk

pytestmark = pytest.mark.cuda

_INT_MIN = -(1 << 31)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(seed, *shape, dev):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32)).to(dev)


def _grid(seed, *shape, dev):
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.integers(-2, 3, size=shape).astype(np.float32)).to(dev)


def _assert_close(got, want, rtol, atol=0.0):
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "b,h,d,nh,nl", [(1000, 32, 64, 4, 3), (37, 10, 64, 2, 1), (64, 8, 32, 4, 2), (9, 40, 64, 4, 2)]
)
def test_encoder_kernel_matches_plain(dev, dtype, b, h, d, nh, nl):
    """B not a multiple of the examples per block; H above a warp's 32
    lanes (40); one layer (only the thin last layer)."""
    r = np.random.default_rng(b + h)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    lim_in, lim_out = math.sqrt(6.0 / (4 * d)), math.sqrt(6.0 / (2 * d))
    x = t(r.normal(size=(b, h, d))).to(dtype)
    args = (
        t(r.normal(size=(h, d)) * 0.5),
        t(r.uniform(-lim_in, lim_in, (nl, d, 3 * d))),
        t(r.uniform(-0.1, 0.1, (nl, 3 * d))),
        t(r.uniform(-lim_out, lim_out, (nl, d, d))),
        t(r.uniform(-0.1, 0.1, (nl, d))),
        nh,
    )
    before = _lib.launches["fused_history_encoder"]
    got = fe.fused_history_encoder(x, *args)
    assert _lib.launches["fused_history_encoder"] == before + 1
    want = fe.fused_history_encoder_plain(x, *args)
    assert got.dtype == dtype and got.shape == (b, 2, d)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    _assert_close(got, want, tol, tol)


@pytest.mark.parametrize(
    "b,c,d,valid", [(1, 4096, 64, 4096), (130, 4000, 32, 4000), (300, 4096, 16, 3000), (257, 8192, 100, 8100)]
)
def test_tile_max_matches_plain_and_rescore_bitwise(dev, b, c, d, valid):
    """Tile maxes against the plain version, and, bit for bit, against the
    max of the rescore kernel's scores over the same tile: the equality the
    exact pipeline's pruning relies on."""
    q, corpus = _randn(1, b, d, dev=dev), _randn(2, c, d, dev=dev)
    m = mt.tile_max_scores(q, corpus, mt.TILE, valid)
    nt = -(-c // mt.TILE)
    assert m.shape == (b, nt)
    _assert_close(m, mt.tile_max_scores_plain(q, corpus, mt.TILE, valid), 1e-5, 1e-5)
    all_tiles = torch.arange(nt, device=dev, dtype=torch.int32).expand(b, nt).contiguous()
    cand = mt.gather_rescore(q, corpus, all_tiles, mt.TILE)
    rows = torch.arange(nt * mt.TILE, device=dev)
    cand = cand.masked_fill(rows >= valid, float("-inf"))
    assert torch.equal(cand.view(b, nt, mt.TILE).amax(-1), m)


def test_tile_max_propagates_nan_like_plain(dev):
    """A NaN corpus row makes its tile's max NaN for every query, as the
    plain amax does; a NaN row at or past valid_count is masked to -inf."""
    b, c, d, valid = 130, 4096, 64, 3000
    q, corpus = _randn(12, b, d, dev=dev), _randn(13, c, d, dev=dev)
    corpus[5, 7] = float("nan")  # tile 0
    corpus[1000, :] = float("nan")  # tile 7
    corpus[3500, 0] = float("nan")  # padding, tile 27
    m = mt.tile_max_scores(q, corpus, mt.TILE, valid)
    want = mt.tile_max_scores_plain(q, corpus, mt.TILE, valid)
    assert torch.equal(m.isnan(), want.isnan())
    assert bool(m[:, 0].isnan().all()) and bool(m[:, 7].isnan().all())
    assert not bool(m[:, 27].isnan().any())
    _assert_close(m.nan_to_num(0.0), want.nan_to_num(0.0), 1e-5, 1e-5)


@pytest.mark.parametrize("b,c,d,k", [(16, 4000, 64, 7), (130, 8192, 32, 100)])
def test_gather_rescore_matches_plain(dev, b, c, d, k):
    """Includes the ragged last tile, whose missing rows score as zeros."""
    q, corpus = _randn(3, b, d, dev=dev), _randn(4, c, d, dev=dev)
    nt = -(-c // mt.TILE)
    tidx = torch.from_numpy(np.random.default_rng(5).integers(0, nt, size=(b, k)).astype(np.int32)).to(dev)
    tidx[0, 0] = nt - 1
    got = mt.gather_rescore(q, corpus, tidx, mt.TILE)
    _assert_close(got, mt.gather_rescore_plain(q, corpus, tidx, mt.TILE), 1e-5, 1e-5)


def _select_cases(dev):
    r = np.random.default_rng(6)
    ties = np.round(r.normal(size=(33, 8192)) * 4) / 4
    ties[0] = 0.0
    zeros = np.round(r.normal(size=(8, 300)) * 2) / 2 * 0.0  # +0.0 and -0.0 only
    nan = r.normal(size=(8, 64)).astype(np.float32)
    nan[:, 40:] = np.uint32(0xFFFFFFFF).view(np.float32)
    nan[:, 10] = np.inf
    nan[:, 11] = np.float32(np.nan)
    big = r.normal(size=(4, 12800))
    return {
        "ties": (ties, 100), "signed-zeros": (zeros, 250), "nan": (nan, 30),
        "pool": (big, 100), "k1": (big, 1), "k-equals-n": (nan, 64),
    }


@pytest.mark.parametrize("case", ["ties", "signed-zeros", "nan", "pool", "k1", "k-equals-n"])
def test_select_matches_plain_exactly(dev, case):
    x, k = _select_cases(dev)[case]
    xt = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
    keys, pos = mt.select_rows(xt, k)
    wk, wp = mt.select_keys_plain(mt.f32_keys(xt).clamp_min(_INT_MIN + 1), k)
    assert torch.equal(keys, wk) and torch.equal(pos, wp)
    vt, it = mt.select_topk_t(xt.T.contiguous(), k)
    assert torch.equal(it.T, pos) and torch.equal(mt.f32_keys(vt.T), keys)


def test_select_hierarchical_matches_plain(dev):
    """Rows longer than the kernel's shared memory (2^17 > 56k keys) split
    into chunks and merge; ties span the chunk seams."""
    x = torch.from_numpy(np.round(np.random.default_rng(7).normal(size=(3, 1 << 17)) * 8).astype(np.float32) / 8).to(dev)
    keys, pos = mt.select_rows(x, 100)
    wk, wp = mt.select_keys_plain(mt.f32_keys(x).clamp_min(_INT_MIN + 1), 100)
    assert torch.equal(keys, wk) and torch.equal(pos, wp)


@pytest.mark.parametrize("b,c,d,k,valid", [(300, 20000, 16, 100, None), (64, 65536, 64, 10, 60000)])
def test_pipeline_matches_dense_exactly(dev, b, c, d, k, valid):
    """Integer-grid embeddings: exact scores, constant ties; indices, tie
    order and scores equal the dense scan's."""
    corpus, q = _grid(8, c, d, dev=dev), _grid(9, b, d, dev=dev)
    before = dict(_lib.launches)
    idx, sc, emb = mt.mips_topk_exact_tiled(corpus, q, k, valid_count=valid)
    for name, n in (("tile_max_scores", 1), ("select_topk", 2), ("gather_rescore", 1)):
        assert _lib.launches[name] == before.get(name, 0) + n
    ridx, rsc, remb = mips_topk(corpus, q, k, valid_count=valid)
    assert torch.equal(idx, ridx) and torch.equal(sc, rsc) and torch.equal(emb, remb)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    q, corpus = _randn(10, 4, 64, dev=dev), _randn(11, 1024, 64, dev=dev)
    with pytest.raises(TypeError):
        mt.tile_max_scores(q.half(), corpus.half(), mt.TILE, 1024)
    with pytest.raises(ValueError):
        mt.tile_max_scores(q, corpus, 64, 1024)
    with pytest.raises(ValueError):
        mt.gather_rescore(q, corpus.cpu(), torch.zeros(4, 2, dtype=torch.int32, device=dev), mt.TILE)
    with pytest.raises(ValueError):
        mt.select_rows(q, 65)
    with pytest.raises(TypeError):
        fe.fused_history_encoder(
            torch.zeros(2, 4, 64, dtype=torch.float16, device=dev),
            torch.zeros(4, 64, device=dev), torch.zeros(1, 64, 192, device=dev),
            torch.zeros(1, 192, device=dev), torch.zeros(1, 64, 64, device=dev),
            torch.zeros(1, 64, device=dev), 4,
        )
