"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: here, without a card, every test skips with its
reason. This file imports no JAX (the machine with the card has none),
so it runs there without the repo's conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

Tolerances: f32 inputs 2e-5 abs (the kernel sums in another order).
bf16 inputs, per element: |got - want| <= 2^-7 |want| + 1e-5. Both
sides compute in f32 and round the output to bf16, so an element may
differ by the one bf16 step its rounding flipped, which is at most
2^-7 of its magnitude; the check stays relative, so it keeps its power
on long rows whose outputs are small (the floor covers elements near
0). The same rule as chip_smoke.py's.
"""

import importlib

import numpy as np
import pytest
import torch

fa = importlib.import_module("tpushare_torch.ops.flash_attention")
attn_mod = importlib.import_module("tpushare_torch.ops.attention")

pytestmark = pytest.mark.cuda

F32_TOL = 2e-5


def _assert_close(got, want, dtype):
    d = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert d.max().item() <= F32_TOL, d.max().item()
    else:
        lim = 2.0 ** -7 * want.float().abs() + 1e-5
        assert bool((d <= lim).all()), (d / lim).max().item()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(gen, *shape, dtype, dev):
    return torch.randn(*shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,q_offset,window,softcap", [
    (1, 128, 128, 8, 1, 256, 0, None, None),
    (2, 17, 200, 4, 2, 128, 150, None, None),
    (1, 1, 77, 8, 8, 128, 76, None, None),
    (1, 130, 300, 32, 8, 128, 170, 50, 30.0),
    (1, 64, 64, 8, 4, 256, 0, 16, 50.0),
])
def test_flash_prefill_vs_plain(dev, dtype, B, Sq, Sk, H, Hkv, D, q_offset,
                                window, softcap):
    g = torch.Generator(device=dev).manual_seed(0)
    q = _rand(g, B, Sq, H, D, dtype=dtype, dev=dev)
    k = _rand(g, B, Sk, Hkv, D, dtype=dtype, dev=dev)
    v = _rand(g, B, Sk, Hkv, D, dtype=dtype, dev=dev)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, q_offset=q_offset, window=window,
                             attn_softcap=softcap)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = attn_mod.mha_reference(q, k, v, q_offset=q_offset, window=window,
                                  attn_softcap=softcap)
    assert got.dtype == dtype and got.shape == q.shape
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,D,bs,window,softcap", [
    (8, 1, 256, 16, None, None),
    (32, 8, 128, 16, None, None),
    (4, 2, 128, 8, 20, 30.0),
    (8, 4, 128, 24, None, 50.0),
])
def test_paged_decode_vs_plain(dev, dtype, H, Hkv, D, bs, window, softcap):
    g = torch.Generator(device=dev).manual_seed(1)
    B, nb, mb = 5, 40, 9
    pool_k = _rand(g, nb, bs, Hkv, D, dtype=dtype, dev=dev)
    pool_v = _rand(g, nb, bs, Hkv, D, dtype=dtype, dev=dev)
    rng = np.random.default_rng(2)
    table = np.full((B, mb), -1, np.int32)
    pos = np.array([0, bs * 3 + 2, bs * mb - 1, 5, 0], np.int32)
    ids = list(rng.permutation(nb - 1))
    for b in range(B - 1):
        n = int(pos[b]) // bs + 1
        table[b, :n] = [ids.pop() for _ in range(n)]
    table[3, 0] = table[1, 0]                      # a shared page
    table[4] = -1                                  # an inactive slot
    table_t = torch.as_tensor(table, device=dev)
    pos_t = torch.as_tensor(pos, device=dev)
    q = _rand(g, B, 1, H, D, dtype=dtype, dev=dev)
    before = fa.paged_flash_decode.launches
    got = fa.paged_flash_decode(q, pool_k, pool_v, table_t, pos_t,
                                window=window, attn_softcap=softcap)
    torch.cuda.synchronize()
    assert fa.paged_flash_decode.launches == before + 1
    want = fa.paged_flash_decode_plain(q, pool_k, pool_v, table_t, pos_t,
                                       window=window, attn_softcap=softcap)
    _assert_close(got, want, dtype)
    assert torch.all(got[4] == 0)


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    q = torch.zeros((1, 4, 2, 32), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    h = torch.zeros((1, 4, 2, 128), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="f32 or bf16"):
        fa.flash_attention(h, h, h)
    q = torch.zeros((1, 8, 2, 128), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                           q.transpose(1, 2))


def test_tiny_server_kernels_match_reference(dev):
    """A tiny bf16 model served twice on the card, kernels vs the plain
    reference path: both kernels launch, first tokens agree."""
    from tpushare_torch.models import paged
    from tpushare_torch.models import transformer as tt
    cfg = tt.TransformerConfig(vocab_size=1000, d_model=256, n_layers=2,
                               n_heads=4, n_kv_heads=2, head_dim=128,
                               d_ff=512)
    params = tt.init_params(0, cfg)
    prompts = [np.arange(5 + 11 * i) % cfg.vocab_size for i in range(3)]
    out = {}
    for impl in ("auto", "reference"):
        fa.flash_attention.launches = fa.paged_flash_decode.launches = 0
        srv = paged.PagedSlotServer(params, cfg, n_slots=4, n_blocks=64,
                                    prefix_cache=True, attn_impl=impl)
        firsts = []
        for p in prompts:
            slot = srv.admit_start(p)
            firsts.append(srv.admit_step(slot))
        steps = [srv.step() for _ in range(4)]
        out[impl] = (firsts, steps, fa.flash_attention.launches,
                     fa.paged_flash_decode.launches)
    assert out["auto"][2] > 0 and out["auto"][3] > 0
    assert out["reference"][2] == 0 and out["reference"][3] == 0
    assert out["auto"][0] == out["reference"][0]
