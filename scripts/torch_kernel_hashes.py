"""SHA-256 of the port's kernels' outputs at the cells.

Hashes, for the checkout it is run from, what B13 (``fused_mha_fwd``), B14
(``fused_mha_bwd``), B1, B5 and B8 (the whole-encoder forward), B6, B7 and
B9 (its backward, B6 on B5's residuals) return at the cells' shape (B =
4096, H = 32, D = 64, four heads, three layers, bf16), without and with
per-example lengths, what B10 (``in_batch_ce_fwd``, with the diagonal) and
B11 + B12 (``in_batch_ce_bwd``) return at the flagship step's (B = C =
4096, D = 64, f32, finite inputs), and what B2 (``tile_max_scores``) and
B4 (``gather_rescore``) return at the serving cell's (B = 1024, C = 2^20,
D = 64, k = 100, ``valid`` inside the last tile; B4 on the tiles the
pipeline selects from B2's output and on a skewed selection, every query
on the same 100 tiles), and what B15 (``blockwise_attn_fwd``: the route
the checkout takes, and its FMA kernel), B16 and B17 (given the plain
version's lse and delta; the route the checkout takes, and, where it has
them, each kernel forced: ``B16_fma``, ``B16_tc``, ...) return at the
blockwise training batch's layer 0
(N = 16384, H = 32, Dh = 16, lengths in [1, 32]), on inputs made from a
numpy seed.
Two checkouts whose kernels compute the same values bit for bit print the
same hashes, so one copy of this script compares two commits on one card:

    python3 scripts/torch_kernel_hashes.py
    (cd ../other_checkout && python3 /abs/path/scripts/torch_kernel_hashes.py)

Prints the card's name and power limit, then one JSON line.  Needs a GPU.
"""

import hashlib
import inspect
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        if t is not None:
            h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from two_tower_models_tpu_torch.ops import fused_encoder as fe
    from two_tower_models_tpu_torch.ops import fused_mha as fm
    from two_tower_models_tpu_torch.ops import fused_softmax as fs
    from two_tower_models_tpu_torch.ops import history_attention as ha
    from two_tower_models_tpu_torch.ops import mips_topk as mt

    dev = torch.device("cuda")
    b, h, d, nh, nl = 4096, 32, 64, 4, 3
    r = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    lim_in, lim_out = np.sqrt(6.0 / (4 * d)), np.sqrt(6.0 / (2 * d))
    x = t(r.normal(size=(b, h, d))).to(torch.bfloat16)
    pe = t(r.normal(size=(h, d)) * 0.5)
    w = [t(r.uniform(-lim_in, lim_in, (nl, d, 3 * d))), t(r.uniform(-0.1, 0.1, (nl, 3 * d))),
         t(r.uniform(-lim_out, lim_out, (nl, d, d))), t(r.uniform(-0.1, 0.1, (nl, d)))]
    g = t(r.normal(size=(b, h, d)) * 0.1).to(torch.bfloat16)
    lens = torch.from_numpy(r.integers(1, h + 1, size=b).astype(np.int32)).to(dev)
    xm = torch.where((torch.arange(h, device=dev)[None, :] < lens[:, None])[..., None], x, 0)
    layer = [t_[0] for t_ in w]
    out = {}
    for tag, ln in (("", None), ("_lens", lens)):
        out["B13" + tag] = digest(fm.fused_mha_fwd(x, ln, *layer, nh))
        out["B14" + tag] = digest(*fm.fused_mha_bwd(g, x, ln, *layer, nh))
    out["B1"] = digest(fe.fused_history_encoder(x, pe, *w, nh))
    res = fe.fused_history_encoder_res(x, pe, *w, nh)
    out["B5"] = digest(*res)
    out["B8"] = digest(fe.fused_attn_stack_fwd(xm, lens, *w, nh))
    g_enc = t(r.normal(size=(b, 2, d)) * 0.1).to(torch.bfloat16)
    g_stack = t(r.normal(size=(b, d)) * 0.1).to(torch.bfloat16)
    out["B6"] = digest(*fe.fused_history_encoder_bwd(g_enc, *res[1:], *w[:3], nh))
    out["B7"] = digest(*fe.fused_history_encoder_bwd_recompute(g_enc, x, pe, *w, nh))
    out["B9"] = digest(*fe.fused_attn_stack_bwd(g_stack, xm, lens, *w, nh))
    del x, g, xm, res
    u, it = t(r.normal(size=(b, d)) * 0.3), t(r.normal(size=(b, d)) * 0.3)
    ce, lse = fs.in_batch_ce_fwd(u, it)
    out["B10"] = digest(ce, lse)
    out["B11_B12"] = digest(*fs.in_batch_ce_bwd(u, it, lse, t(r.normal(size=b)) / b))
    del u, it, ce, lse
    nb, c, k = 1024, 1 << 20, 100
    q = t(r.normal(size=(nb, d)))
    corpus = t(r.normal(size=(c, d)))
    valid = c - 77
    m = mt.tile_max_scores(q, corpus, mt.TILE, valid)
    tiles = torch.sort(mt.select_rows(m, k)[1], dim=1).values
    skew = torch.from_numpy(np.sort(r.choice(c // mt.TILE, k, replace=False)).astype(np.int32))
    skew = skew.to(dev)[None, :].expand(nb, k).contiguous()
    out["B2"] = digest(m)
    out["B4"] = digest(mt.gather_rescore(q, corpus, tiles, mt.TILE))
    out["B4_skewed"] = digest(mt.gather_rescore(q, corpus, skew, mt.TILE))
    del q, corpus, m, tiles, skew
    qa, ka, va, da = (t(r.normal(size=(16384, 32, 16))) for _ in range(4))
    la = torch.from_numpy(r.integers(1, 33, size=16384).astype(np.int32)).to(dev)
    out["B15"] = digest(*ha.blockwise_attn_fwd(qa, ka, va, la))
    routed = "_route" in inspect.signature(ha.blockwise_attn_fwd).parameters
    out["B15_fma"] = digest(*(ha.blockwise_attn_fwd(qa, ka, va, la, _route="fma") if routed
                              else ha.blockwise_attn_fwd(qa, ka, va, la)))
    o_p, lse_p = ha.blockwise_attn_fwd_plain(qa, ka, va, la)
    bargs = (qa, ka, va, da, lse_p, (da * o_p).sum(-1), la)
    out["B16"] = digest(ha.blockwise_attn_dq(*bargs))
    out["B17"] = digest(*ha.blockwise_attn_dkv(*bargs))
    if "_route" in inspect.signature(ha.blockwise_attn_dq).parameters:
        for route in ("fma", "tc"):
            out[f"B16_{route}"] = digest(ha.blockwise_attn_dq(*bargs, _route=route))
            out[f"B17_{route}"] = digest(*ha.blockwise_attn_dkv(*bargs, _route=route))
    torch.cuda.synchronize()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps({"checkout": os.getcwd(), "hashes": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
