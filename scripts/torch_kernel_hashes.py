"""SHA-256 of the port's tensor-core attention kernels' outputs at the cells.

Hashes, for the checkout it is run from, what B13 (``fused_mha_fwd``), B14
(``fused_mha_bwd``), B1, B5 and B8 (the whole-encoder forward) return at
the cells' shape (B = 4096, H = 32, D = 64, four heads, three layers, bf16),
without and with per-example lengths, on inputs made from a numpy seed.
Two checkouts whose kernels compute the same values bit for bit print the
same hashes, so one copy of this script compares two commits on one card:

    python3 scripts/torch_kernel_hashes.py
    (cd ../other_checkout && python3 /abs/path/scripts/torch_kernel_hashes.py)

Prints the card's name and power limit, then one JSON line.  Needs a GPU.
"""

import hashlib
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
    out["B5"] = digest(*fe.fused_history_encoder_res(x, pe, *w, nh))
    out["B8"] = digest(fe.fused_attn_stack_fwd(xm, lens, *w, nh))
    torch.cuda.synchronize()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps({"checkout": os.getcwd(), "hashes": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
