"""Times the split-KV decode walk (csrc/decode_tile.cuh) at 1, 2 and 4
times the split count that ``ops.flash_attention.decode_splits`` picks,
on chip_smoke.py's six decode cases: the same shapes, positions and page
counts, random inputs from a fixed seed. Each factor stands in for a
card with that many times the SMs, and ``decode_splits`` still caps the
count at one split per tile of the longest slot a cache can hold.

Run from the repository root on a machine with a CUDA card:

    python -m tpushare_torch.tools.decode_split_sweep

Prints the card's ``nvidia-smi`` name and power limit, then one JSON
line per (case, factor): the split count, the device ms by
chip_smoke.py's ``time_ms`` (the stream held until the loop is
enqueued, L2 overwritten before each launch) and the output's
``ulp_ratio`` against the plain version under chip_smoke.py's gate.
Exits 2 without a card, 1 if an output breaks the gate.
"""
from __future__ import annotations

import importlib
import json
import sys
from unittest import mock

FACTORS = (1, 2, 4)


def _fa():
    # The module: the package's own ``flash_attention`` is the function.
    return importlib.import_module("tpushare_torch.ops.flash_attention")


def _paged_inputs(torch, np, dev, pos, pages, H, Hkv, D, nb, mb, int8):
    from tpushare_torch.models.quant import kv_quantize, scales_to_pool_layout
    bs, B = 16, len(pos)
    rng = np.random.default_rng(1)
    g = torch.Generator(device=dev).manual_seed(1)
    k = torch.randn(nb, bs, Hkv, D, generator=g, device=dev)
    v = torch.randn(nb, bs, Hkv, D, generator=g, device=dev)
    kw = {}
    if int8:
        (k, ks), (v, vs) = kv_quantize(k), kv_quantize(v)
        kw = {"k_scale": scales_to_pool_layout(ks),
              "v_scale": scales_to_pool_layout(vs)}
    else:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    table = np.full((B, mb), -1, np.int32)
    ids = list(rng.permutation(nb - 1))
    for b in range(B):
        table[b, :pages[b]] = [ids.pop() for _ in range(pages[b])]
    q = torch.randn(B, 1, H, D, generator=g, device=dev).to(torch.bfloat16)
    return (q, k, v, torch.as_tensor(table, device=dev),
            torch.as_tensor(np.asarray(pos, np.int32), device=dev)), kw


def _row_inputs(torch, np, dev, pos, M, H, Hkv, D):
    g = torch.Generator(device=dev).manual_seed(6)
    B = len(pos)
    k, v = (torch.randn(B, M, Hkv, D, generator=g, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    q = torch.randn(B, 1, H, D, generator=g, device=dev).to(torch.bfloat16)
    return q, k, v, torch.as_tensor(np.asarray(pos, np.int32), device=dev)


def cases(torch, np, dev):
    """(name, kernel, plain, args, kwargs) of chip_smoke.py's decode
    cases, positions worked out as its main() works them out."""
    import chip_smoke
    from tpushare_torch.models import paged, serving
    fa = _fa()
    bs = 16
    dec_pos = [n + 31 for n in (16, 100, 255, 511, 700, 1024, 1500, 2048)]
    dec_pages = [p // bs + 1 for p in dec_pos]
    _, l_base, l_spec_pages = chip_smoke.llama_schedule(
        serving, paged, [100, 511, 1024, 2048], [700, 1500, 2048, 3000],
        512, bs, 4)
    g_pos = [n + 16 for n in (200, 700, 1500, 4500, 6000)] + [315, 0, 0]
    pd, pdp = fa.paged_flash_decode, fa.paged_flash_decode_plain
    fd, fdp = fa.flash_decode, fa.flash_decode_plain
    out = []
    for name, pos, pages, H, Hkv, D, nb, mb, int8, kw in (
            ("gemma2b_b8", dec_pos, dec_pages, 8, 1, 256, 1024, 1024,
             False, {}),
            ("llama3_8b_draft_b8", l_base, l_spec_pages, 32, 8, 128, 2049,
             256, False, {}),
            ("gemma2_window_softcap", dec_pos, dec_pages, 8, 4, 256, 1024,
             1024, False, {"window": 1024, "attn_softcap": 50.0}),
            ("llama3_8b_kvq_b8", l_base, [n // bs + 1 for n in l_base], 32,
             8, 128, 2049, 256, True, {})):
        args, skw = _paged_inputs(torch, np, dev, pos, pages, H, Hkv, D, nb,
                                  mb, int8)
        out.append((name, pd, pdp, args, {**kw, **skw}))
    for name, window in (("gemma2_2b_local", 4096), ("gemma2_2b_global",
                                                     None)):
        out.append((name, fd, fdp, _row_inputs(torch, np, dev, g_pos, 8192,
                                               8, 4, 256),
                    {"window": window, "attn_softcap": 50.0}))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("decode_split_sweep: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    import chip_smoke
    fa = _fa()
    dev = torch.device("cuda")
    print(chip_smoke.nvidia_smi(), flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    bad = 0
    for name, kern, plain, args, kw in cases(torch, np, dev):
        want = plain(*args, **kw)
        q, k = args[0], args[1]
        B, _, H, _ = q.shape
        Hkv = k.shape[2]
        rows = (args[3].shape[1] * k.shape[1] if kern is fa.paged_flash_decode
                else k.shape[1])
        for f in FACTORS:
            with mock.patch.object(fa, "_sm_count", lambda i: f * sms):
                got = kern(*args, **kw)
                ratio = chip_smoke.compare(got, want)["ulp_ratio"]
                ms = chip_smoke.time_ms(lambda: kern(*args, **kw), 50, flush)
            bad += not ratio <= 1.0
            print(json.dumps({"case": name, "factor": f,
                              "splits": fa.decode_splits(B, H, Hkv, rows,
                                                         f * sms),
                              "ms": ms, "ulp_ratio": ratio}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
