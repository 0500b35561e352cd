"""portbench/flops.py against hand reckonings at the published widths,
and the paged key count against a brute-force walk."""

import numpy as np
import pytest

from portbench import flops, harness

MIXTRAL = harness.load_json(f"{harness.PB}/configs/mixtral-8x7b-int8.json")
MISTRAL = harness.load_json(f"{harness.PB}/configs/mistral-7b.json")


def test_mixtral_active_parameters():
    # Per layer: q, k, v, o = 4096 * (4096 + 2 * 1024) + 4096 * 4096 =
    # 41.94 M; router 4096 * 8; two experts 2 * 3 * 4096 * 14336 =
    # 352.3 M. 32 layers plus embedding and head (2 * 32000 * 4096).
    per_layer = 41_943_040 + 32_768 + 352_321_536
    assert flops.layer_matmul_params(MIXTRAL) == per_layer
    n = flops.active_params_per_token(MIXTRAL)
    assert n == 32 * per_layer + 2 * 32000 * 4096
    assert abs(n / 1e9 - 12.88) < 0.01          # "about 12.9 B"


def test_mistral_parameters():
    # 32 * (41.94 M + 176.16 M) + 262.1 M = 7.24 B, the published size.
    n = flops.active_params_per_token(MISTRAL)
    assert abs(n / 1e9 - 7.24) < 0.01


def test_token_flops():
    m = flops.dims(MISTRAL)
    body = 2 * flops.layer_matmul_params(MISTRAL)
    attn = 4 * 32 * 128 * 1000
    head = 2 * 4096 * 32000
    assert flops.model_token_flops(MISTRAL, 1000, True) == \
        m["layers"] * (body + attn) + head
    assert flops.model_token_flops(MISTRAL, 1000, False) == \
        m["layers"] * (body + attn)
    # A prefill of [c, S) is the sum of its tokens, with one head.
    c, S = 100, 164
    want = sum(flops.model_token_flops(MISTRAL, p + 1, False)
               for p in range(c, S)) + head
    assert flops.prefill_flops(MISTRAL, c, S) == pytest.approx(want)
    assert flops.decode_flops(MISTRAL, 99) == \
        flops.model_token_flops(MISTRAL, 100, True)


def test_flash_attention_work():
    # One head of 128, 4 query rows at positions 10..13 over 20 keys:
    # 11 + 12 + 13 + 14 keys; reads q and 14 keys' k and v, writes out.
    f, b = flops.flash_attention_work((1, 4, 1, 128), (1, 20, 1, 128), 10,
                                      2)
    assert f == 4 * 128 * (11 + 12 + 13 + 14)
    assert b == (2 * 4 * 128 + 2 * 14 * 128) * 2


def _brute_keys(table, pos, Sq, bs):
    B, mb = table.shape
    out = np.zeros((B, Sq), np.int64)
    for b in range(B):
        for s in range(Sq):
            for p in range(mb * bs):
                if p <= pos[b] + s and table[b, p // bs] >= 0:
                    out[b, s] += 1
    return out


def test_paged_keys_brute_force():
    rng = np.random.default_rng(0)
    table = rng.integers(-1, 50, (5, 6)).astype(np.int32)
    table[0] = -1
    pos = rng.integers(0, 6 * 4, 5).astype(np.int32)
    for Sq in (1, 3):
        assert (flops.paged_keys(table, pos, Sq, 4)
                == _brute_keys(table, pos, Sq, 4)).all()


def test_paged_work_counts_live_kv_once():
    table = np.array([[0, 1, -1], [2, -1, -1]], np.int32)
    pos = np.array([20, 3], np.int32)             # block size 16
    f, b = flops.paged_attention_work(table, pos, (2, 1, 32, 128), 16, 2, 2,
                                      8)
    assert f == 4 * 32 * 128 * (21 + 4)
    kv = 2 * (21 + 4) * 8 * 128 * 2
    assert b == kv + 2 * 2 * 32 * 128 * 2 + 4 * (6 + 2)


def test_q8_expert_work_counts_the_routed_rows():
    """2048 token rows, top-2 of 8 experts, all 8 touched: the products of
    the 4096 routed rows, the touched experts' weights, the rows in and
    the routed rows out."""
    f, b = flops.q8_expert_work(2048, 4096, 8, 4096, 14336, 2)
    assert f == 2 * 4096 * 3 * 4096 * 14336
    w = 8 * (3 * 4096 * 14336 + 4 * (2 * 14336 + 4096))
    assert b == 2048 * 4096 * 2 + w + 4096 * 4096 * 2
    # A quarter of dense dispatch's 5.84 ms compute bound at C 2048.
    assert flops.least_seconds(f, b, "NVIDIA H100 80GB HBM3") == \
        pytest.approx(5.84e-3 / 4, rel=0.01)
    # One decode token, top-2: two experts' weights, bandwidth-bound.
    f1, b1 = flops.q8_expert_work(1, 2, 2, 4096, 14336, 2)
    assert b1 == 2 * (3 * 4096 * 14336 + 4 * (2 * 14336 + 4096)) \
        + 4096 * 2 + 2 * 4096 * 2
    assert flops.least_seconds(f1, b1, "NVIDIA H100 80GB HBM3") == \
        pytest.approx(b1 / 3.35e12)


def test_unknown_card_has_no_peaks():
    with pytest.raises(RuntimeError):
        flops.peaks("NVIDIA H100 PCIe")
    assert flops.peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)


def test_step_mfu_reader_counts_the_untraced_part():
    """One request: its prefill's first token and two decoded tokens fall
    inside the untraced part [10, 12); a third token in the traced part
    after it is not counted."""
    import types
    mfu = harness.load_file(f"{harness.PB}/metrics/model.step_mfu_pct.py",
                            "mfu")
    req = types.SimpleNamespace(tokens=[1, 2, 3, 4],
                                t_tokens=[10.5, 11.0, 11.5, 12.5],
                                error=None, cached_prefix=100)
    rec = harness.Record(0, 0, list(range(1000)), 4, 10.0, req)
    run = harness.Run(MISTRAL, "card", 10.0, 20.0, [rec], {}, {}, 1.0,
                      peaks=(1e15, 1e12), t_split=12.0, stats_split={})
    want = (flops.prefill_flops(MISTRAL, 100, 1000)
            + flops.decode_flops(MISTRAL, 1000)
            + flops.decode_flops(MISTRAL, 1001))
    assert mfu.read(run) == pytest.approx(100 * want / (2.0 * 1e15))
    run.peaks = None
    assert mfu.read(run) is None
