"""Parity of the port's int8 helpers (tpushare_torch.models.quant) with
the JAX package's, on the CPU: the same numpy inputs, made from a seed,
go through both.

Int8 values must be EQUAL; scales agree within 1 f32 ulp (both compute
one f32 absmax and one f32 divide, so they are normally identical; the
ulp allows a library's divide to round the other way). Both frameworks
round half to even, pinned here by exact ties. Dequantized weights and
hook outputs agree within 1e-6 (the same f32 product, then the cast).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.models import quant as jq
from tpushare.models import transformer as jt

from tpushare_torch.models import bridge
from tpushare_torch.models import quant as tq

tt = importlib.import_module("tpushare_torch.models.transformer")


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64)).max()


class TestWeights:
    def test_quantize_layers_matches_jax(self):
        layers = {"wq": _np(0, 3, 16, 24, scale=0.3),
                  "w_down": _np(1, 3, 40, 16, scale=2.0),
                  "ln1": _np(2, 3, 16)}
        want = jq.quantize_layers({k: jnp.asarray(v)
                                   for k, v in layers.items()})
        got = tq.quantize_layers({k: torch.from_numpy(v)
                                  for k, v in layers.items()})
        assert sorted(got) == sorted(want)
        for k in ("wq#q8", "w_down#q8"):
            assert got[k].dtype == torch.int8
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        for k in ("wq#scale", "w_down#scale"):
            assert got[k].shape == want[k].shape
            assert _ulps(got[k].numpy(), want[k]) <= 1
        np.testing.assert_array_equal(got["ln1"].numpy(), layers["ln1"])

    def test_round_half_to_even_ties(self):
        """A column whose absmax is 127 has scale exactly 1, so w / s
        hits x.5 ties: 2.5 -> 2, 3.5 -> 4, -0.5 -> 0, -1.5 -> -2."""
        col = np.array([127.0, 2.5, 3.5, -0.5, -1.5, 0.0],
                       np.float32)
        w = np.stack([col, col * 0.5], axis=1)[None]      # [1, 6, 2]
        want = jq.quantize_layers({"wq": jnp.asarray(w)})["wq#q8"]
        got = tq.quantize_layers({"wq": torch.from_numpy(w)})["wq#q8"]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got[0, :5, 0].tolist() == [127, 2, 4, 0, -2]

    def test_all_zero_column_keeps_the_scale_floor(self):
        w = np.zeros((1, 4, 3), np.float32)
        got = tq.quantize_layers({"wk": torch.from_numpy(w)})
        want = jq.quantize_layers({"wk": jnp.asarray(w)})
        np.testing.assert_array_equal(got["wk#scale"].numpy(),
                                      np.asarray(want["wk#scale"]))
        assert torch.all(got["wk#q8"] == 0)

    def test_dequant_hook_matches_jax(self):
        jcfg = jt.tiny(remat=False)
        tcfg = bridge.config_from_jax(jcfg)
        jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
        jqp = jq.quantize_params(jp, jcfg)
        tqp = bridge.params_from_jax(jqp, device="cpu")
        jlayer = {k: v[1] for k, v in jqp["layers"].items()}
        tlayer = {k: v[1] for k, v in tqp["layers"].items()}
        want = jq.dequant_hook(jcfg)(jlayer)
        got = tq.dequant_hook(tcfg)(tlayer)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == tcfg.dtype
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=0, atol=1e-6)
        assert tq.dequant_hook(tcfg) is tq.dequant_hook(tcfg)   # memoized

    def test_bridge_keeps_int8_and_f32_scale_leaves(self):
        jcfg = jt.tiny(remat=False)
        jp = jt.init_params(jax.random.PRNGKey(1), jcfg)
        jqp = jq.quantize_params(jp, jcfg)
        tqp = bridge.params_from_jax(jqp, device="cpu",
                                     dtype=torch.bfloat16)
        for k, v in jqp["layers"].items():
            t = tqp["layers"][k]
            if k.endswith("#q8"):
                assert t.dtype == torch.int8
                np.testing.assert_array_equal(t.numpy(), np.asarray(v))
            elif k.endswith("#scale"):
                assert t.dtype == torch.float32
                np.testing.assert_array_equal(t.numpy(), np.asarray(v))
            else:
                assert t.dtype == torch.bfloat16
        assert tqp["embed"].dtype == torch.bfloat16

    def test_quantize_params_shares_the_unquantized_leaves(self):
        cfg = tt.tiny()
        p = tt.init_params(0, cfg, device="cpu")
        qp = tq.quantize_params(p, cfg)
        assert qp["embed"] is p["embed"]
        assert qp["layers"]["ln1"] is p["layers"]["ln1"]
        assert "wq" not in qp["layers"] and "wq#q8" in qp["layers"]


class TestKv:
    def test_kv_quantize_matches_jax(self):
        rows = _np(5, 2, 7, 3, 32, scale=4.0)
        jqv, jsv = jq.kv_quantize(jnp.asarray(rows))
        tqv, tsv = tq.kv_quantize(torch.from_numpy(rows))
        assert tqv.dtype == torch.int8 and tsv.dtype == torch.float32
        np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
        assert _ulps(tsv.numpy(), jsv) <= 1
        for dtype, jdtype in ((torch.float32, jnp.float32),
                              (torch.bfloat16, jnp.bfloat16)):
            got = tq.kv_dequantize(tqv, tsv, dtype)
            want = jq.kv_dequantize(jqv, jsv, jdtype)
            assert got.dtype == dtype
            np.testing.assert_allclose(
                got.float().numpy(),
                np.asarray(want.astype(jnp.float32)), rtol=0, atol=1e-6)

    def test_kv_round_half_to_even_ties(self):
        row = np.array([[127.0, 0.5, 1.5, -2.5, 3.5, -126.5]], np.float32)
        want, _ = jq.kv_quantize(jnp.asarray(row))
        got, s = tq.kv_quantize(torch.from_numpy(row))
        assert float(s[0]) == 1.0
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got[0].tolist() == [127, 0, 2, -2, 4, -126]

    def test_requantizing_a_dequantized_row_is_exact(self):
        """The reference's exactness property: absmax scales map the
        max-|x| entry to +-127, so a dequantized row requantizes to the
        same (int8, scale) pair."""
        q, s = tq.kv_quantize(torch.from_numpy(_np(6, 5, 4, 64)))
        q2, s2 = tq.kv_quantize(tq.kv_dequantize(q, s, torch.float32))
        assert torch.equal(q, q2) and torch.equal(s, s2)

    def test_init_cache_q8(self):
        jcfg = jt.tiny(remat=False)
        want = jq.init_cache_q8(jcfg, 2, 12)
        got = tq.init_cache_q8(bridge.config_from_jax(jcfg), 2, 12,
                               device="cpu")
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape
        assert got["k"].dtype == torch.int8
        assert got["k_scale"].dtype == torch.float32

    @pytest.mark.parametrize("hkv", [1, 2, 8, 9])
    def test_scale_pages_convert_to_the_jax_layout(self, hkv):
        """The port's unpadded [.., Hkv, bs] pages are JAX's padded
        [.., Hkv_pad, bs] pages without the pad heads."""
        rows = np.abs(_np(7, 3, 5, 16, hkv))            # [L, nb, bs, Hkv]
        want = np.asarray(jq.scales_to_pool_layout(jnp.asarray(rows)))
        got = tq.scales_to_pool_layout(torch.from_numpy(rows))
        assert got.is_contiguous()
        assert want.shape[-2] == jq.kv_scale_pad(hkv)
        np.testing.assert_array_equal(got.numpy(), want[..., :hkv, :])
        assert not want[..., hkv:, :].any()
        np.testing.assert_array_equal(
            tq.pool_scales_to_rows(got).numpy(),
            np.asarray(jq.pool_scales_to_rows(jnp.asarray(want), hkv)))
