"""Parity of the port's transformer (tpushare_torch.models.transformer)
with the JAX package's, on the CPU in f32, weights carried across by
``bridge.params_from_jax``.

Covers forward's ported branches (no cache, dense scalar offset with
bf16/f32 or int8 rows, dense ragged S=1 and S>1 over plain or int8
rows, paged S=1 and S>1 over plain or int8 pools, ``layers_hook``),
``prefill`` / ``chunked_prefill`` / ``decode_step``, the configs'
spots where the two frameworks round
differently (embedding scale, tanh gelu, logits cast), init_params'
tree, and the branches that must refuse until their ROADMAP item lands.
Tolerance: 2e-5 abs on f32 logits — the two libraries sum the same
products in different orders (matmul blocking, softmax), nothing else.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.models import transformer as jt

from tpushare_torch.models import bridge
from tpushare_torch.models import transformer as tt

ATOL = 2e-5

CONFIGS = {
    "tiny": {},
    "gemma": {"norm_offset": 1.0, "embed_scale": True, "act": "gelu"},
    "llama": {"tie_embeddings": False, "rope_base": 5e5,
              "rope_scaling": (8.0, 1.0, 4.0, 64)},
    "gemma2": {"norm_offset": 1.0, "embed_scale": True, "act": "gelu",
               "sliding_window": 6, "alternate_sliding": True,
               "attn_softcap": 20.0, "final_softcap": 15.0,
               "post_norms": True, "attn_scale": 0.15},
}


def _pair(name, seed=0):
    jcfg = jt.tiny(remat=False, **CONFIGS[name])
    jp = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    if jcfg.post_norms or jcfg.norm_offset:
        # Zero-init norms would hide a wrong offset: give them values.
        rng = np.random.default_rng(seed)
        jp = jax.tree.map(lambda a: a + jnp.asarray(
            rng.normal(size=a.shape) * 0.1, a.dtype) if a.ndim <= 2 else a,
            jp)
    tcfg = bridge.config_from_jax(jcfg)
    return jcfg, jp, tcfg, bridge.params_from_jax(jp, device="cpu")


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=0, atol=atol)


def _close_int8(got_q, want_q, got_s, want_s):
    """Int8 K/V written by both frameworks from K/V rows that their
    matmuls compute a few f32 ulps apart: a code moves by one only where
    x / s sits on a rounding edge (well under 1 in 1000 codes), and the
    scales agree to f32 rounding."""
    d = np.abs(np.asarray(got_q, np.int32) - np.asarray(want_q, np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())
    np.testing.assert_allclose(np.asarray(got_s, np.float32),
                               np.asarray(want_s, np.float32),
                               rtol=1e-5, atol=0)


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S))


class TestConfig:
    def test_bridge_keeps_every_field(self):
        for make in (jt.gemma_2b, jt.gemma2_2b, jt.llama3_8b):
            jcfg = make()
            tcfg = bridge.config_from_jax(jcfg)
            assert tcfg.dtype == torch.bfloat16
            for f in ("vocab_size", "d_model", "n_layers", "n_heads",
                      "n_kv_heads", "head_dim", "d_ff", "act",
                      "norm_offset", "embed_scale", "tie_embeddings",
                      "sliding_window", "attn_softcap", "final_softcap",
                      "post_norms", "rope_base", "attn_scale"):
                assert getattr(tcfg, f) == getattr(jcfg, f), f
            assert tcfg.num_params() == jcfg.num_params()

    def test_presets_match(self):
        for jm, tm in ((jt.gemma_2b, tt.gemma_2b),
                       (jt.gemma2_2b, tt.gemma2_2b),
                       (jt.llama3_8b, tt.llama3_8b)):
            assert bridge.config_from_jax(jm()) == tm()
        assert bridge.config_from_jax(jt.tiny()) == tt.tiny()

    def test_layer_windows(self):
        cfg = tt.tiny(n_layers=4, sliding_window=5, alternate_sliding=True)
        jcfg = jt.tiny(n_layers=4, sliding_window=5, alternate_sliding=True)
        assert tt.layer_windows(cfg) == list(np.asarray(
            jt.layer_windows(jcfg)))
        assert tt.layer_windows(tt.tiny()) is None

    @pytest.mark.parametrize("name", ["tiny", "gemma2", "llama"])
    def test_init_params_tree(self, name):
        jcfg = jt.tiny(**CONFIGS[name])
        shapes = jax.eval_shape(lambda: jt.init_params(
            jax.random.PRNGKey(0), jcfg))
        tp = tt.init_params(3, bridge.config_from_jax(jcfg), device="cpu")
        jflat = jax.tree_util.tree_flatten_with_path(shapes)[0]
        assert len(jflat) == sum(1 for _ in _leaves(tp))
        for path, leaf in jflat:
            t = _get(tp, path)
            assert tuple(t.shape) == leaf.shape, path
        bound = 2 / np.sqrt(jcfg.d_model)
        assert float(tp["layers"]["wq"].abs().max()) <= bound
        fill = 0.0 if jcfg.norm_offset else 1.0
        assert torch.all(tp["final_norm"] == fill)
        # Seeded: the same generator seed gives the same weights.
        again = tt.init_params(3, bridge.config_from_jax(jcfg), device="cpu")
        assert torch.equal(again["embed"], tp["embed"])


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _get(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


class TestRounding:
    def test_embed_scale_rounds_to_dtype_first(self):
        """Gemma's sqrt(d_model) multiplier is a bf16 constant BEFORE
        the multiply (transformer.py:333-334): bit-equal in bf16."""
        emb = np.random.default_rng(1).normal(size=(64, 2048)) \
            .astype(np.float32)
        je = jnp.asarray(emb, jnp.bfloat16)
        want = je * jnp.asarray(np.sqrt(2048), jnp.bfloat16)
        te = torch.from_numpy(emb).to(torch.bfloat16)
        got = te * torch.tensor(np.sqrt(2048), dtype=torch.bfloat16)
        assert np.array_equal(np.asarray(want.astype(jnp.float32)),
                              got.float().numpy())

    def test_gelu_is_tanh_approximation(self):
        x = np.linspace(-6, 6, 101).astype(np.float32)
        _close(tt._act("gelu", torch.from_numpy(x)),
               jt._act("gelu", jnp.asarray(x)), atol=1e-6)
        _close(tt._act("silu", torch.from_numpy(x)),
               jt._act("silu", jnp.asarray(x)), atol=1e-6)


class TestForwardParity:
    @pytest.mark.parametrize("name", list(CONFIGS))
    def test_no_cache(self, name):
        jcfg, jp, tcfg, tp = _pair(name)
        toks = _tokens(1, 2, 11, jcfg.vocab_size)
        want, _ = jt.forward(jp, jnp.asarray(toks), jcfg)
        got, cache = tt.forward(tp, torch.from_numpy(toks), tcfg)
        assert cache is None and got.dtype == torch.float32
        _close(got, want)
        last, _ = tt.forward(tp, torch.from_numpy(toks), tcfg,
                             last_logit_only=True)
        _close(last[:, 0], want[:, -1])

    @pytest.mark.parametrize("name", list(CONFIGS))
    def test_dense_scalar_offset(self, name):
        """Admission prefill into a row cache, in two chunks (the second
        at q_offset 8), then a write whose start must CLAMP so it fits
        (dynamic_update_slice semantics)."""
        jcfg, jp, tcfg, tp = _pair(name, seed=2)
        M = 24
        toks = _tokens(2, 1, 20, jcfg.vocab_size)
        jc = jt.init_cache(jcfg, 1, M)
        tc = tt.init_cache(tcfg, 1, M, device="cpu")
        for lo, hi in ((0, 8), (8, 16), (20, 24)):
            piece = toks[:, lo:hi] if hi <= 20 else toks[:, 12:16]
            want, jc = jt.forward(jp, jnp.asarray(piece), jcfg, cache=jc,
                                  pos_offset=lo)
            got, tc = tt.forward(tp, torch.from_numpy(piece), tcfg,
                                 cache=tc, pos_offset=lo)
            _close(got, want)
            _close(tc["k"], jc["k"])
            _close(tc["v"], jc["v"])

    @pytest.mark.parametrize("name", list(CONFIGS))
    @pytest.mark.parametrize("attn_impl", ["auto", "reference"])
    def test_paged_decode(self, name, attn_impl):
        """One ragged S=1 step over a paged pool: -1 entries, a shared
        block, an inactive slot (written to the trash block) and a slot
        whose position is past its capacity (also trash)."""
        jcfg, jp, tcfg, tp = _pair(name, seed=3)
        L, nb, bs, mb = jcfg.n_layers, 12, 4, 4
        rng = np.random.default_rng(4)
        shape = (L, nb, bs, jcfg.n_kv_heads, jcfg.head_dim)
        pk = rng.normal(size=shape).astype(np.float32)
        pv = rng.normal(size=shape).astype(np.float32)
        table = np.array([[0, 3, -1, -1], [5, 1, 2, -1], [0, 7, -1, -1],
                          [8, 9, 10, 4], [6, -1, -1, -1]], np.int32)
        pos = np.array([6, 9, 5, 16, 2], np.int32)
        active = np.array([True, True, True, True, False])
        toks = _tokens(5, 5, 1, jcfg.vocab_size)
        want, jcache = jt.forward(
            jp, jnp.asarray(toks), jcfg,
            cache={"pool_k": jnp.asarray(pk), "pool_v": jnp.asarray(pv),
                   "table": jnp.asarray(table),
                   "active": jnp.asarray(active)},
            pos_offset=jnp.asarray(pos), attn_impl="reference")
        tcache = {"pool_k": torch.from_numpy(pk.copy()),
                  "pool_v": torch.from_numpy(pv.copy()),
                  "table": torch.from_numpy(table),
                  "active": torch.from_numpy(active)}
        got, tcache = tt.forward(tp, torch.from_numpy(toks), tcfg,
                                 cache=tcache,
                                 pos_offset=torch.from_numpy(pos),
                                 attn_impl=attn_impl)
        # Slot 3 writes to trash (pos 16 == capacity) and, like the
        # inactive slot, its logits are not a served token's.
        _close(got[:3], want[:3])
        _close(tcache["pool_k"][:, :-1], jcache["pool_k"][:, :-1])
        _close(tcache["pool_v"][:, :-1], jcache["pool_v"][:, :-1])


def _jax_scale_pages(s):
    """Port scale pages [L, nb, Hkv, bs] -> JAX's [L, nb, Hkv_pad, bs]."""
    from tpushare.models.quant import kv_scale_pad
    L, nb, hkv, bs = s.shape
    out = np.zeros((L, nb, kv_scale_pad(hkv), bs), np.float32)
    out[:, :, :hkv] = s
    return out


# Paged S>1 case: 6 slots, 3 tokens each, bs 4, 5 blocks per slot.
# Slot 2 shares slot 0's block 0 (a prefix hit); slot 3's third token
# sits at position 20 = capacity; slot 4 is inactive; slot 5's tokens 1
# and 2 land under a -1 entry. Those rows write to the trash block and
# their logits are not a served token's: ``_VALID`` marks the rest.
_TABLE = np.array([[0, 3, 11, -1, -1], [5, 1, 2, 12, -1],
                   [0, 7, -1, -1, -1], [8, 9, 10, 4, 13],
                   [6, -1, -1, -1, -1], [14, -1, -1, -1, -1]], np.int32)
_POS = np.array([6, 9, 5, 18, 2, 3], np.int32)
_ACTIVE = np.array([True, True, True, True, False, True])
_VALID = np.ones((6, 3), bool)
_VALID[3, 2] = _VALID[4] = _VALID[5, 1:] = False


class TestPagedMultiToken:
    @pytest.mark.parametrize("int8", [False, True])
    @pytest.mark.parametrize("name", ["tiny", "gemma", "llama", "gemma2"])
    @pytest.mark.parametrize("attn_impl", ["auto", "reference"])
    def test_vs_jax(self, name, int8, attn_impl):
        """The paged S>1 branch (speculative verify, fused tick): writes
        at pos[b] + j with the trash routing, then attention through the
        table. Int8 pools quantize on write; the reference dequantizes
        to cfg.dtype (f32 here), the kernel's plain version in f32."""
        from tpushare.models import quant as jq
        from tpushare_torch.models import quant as tq
        jcfg, jp, tcfg, tp = _pair(name, seed=6)
        L, nb, bs = jcfg.n_layers, 16, 4
        rng = np.random.default_rng(7)
        shape = (L, nb, bs, jcfg.n_kv_heads, jcfg.head_dim)
        pk = rng.normal(size=shape).astype(np.float32)
        pv = rng.normal(size=shape).astype(np.float32)
        jc = {"table": jnp.asarray(_TABLE), "active": jnp.asarray(_ACTIVE)}
        tc = {"table": torch.from_numpy(_TABLE),
              "active": torch.from_numpy(_ACTIVE)}
        if int8:
            (qk, sk), (qv, sv) = (tq.kv_quantize(torch.from_numpy(a))
                                  for a in (pk, pv))
            sk, sv = (tq.scales_to_pool_layout(x) for x in (sk, sv))
            jc.update(pool_k=jnp.asarray(qk.numpy()),
                      pool_v=jnp.asarray(qv.numpy()),
                      pool_k_scale=jnp.asarray(_jax_scale_pages(sk.numpy())),
                      pool_v_scale=jnp.asarray(_jax_scale_pages(sv.numpy())))
            tc.update(pool_k=qk, pool_v=qv, pool_k_scale=sk,
                      pool_v_scale=sv)
        else:
            jc.update(pool_k=jnp.asarray(pk), pool_v=jnp.asarray(pv))
            tc.update(pool_k=torch.from_numpy(pk.copy()),
                      pool_v=torch.from_numpy(pv.copy()))
        toks = _tokens(8, 6, 3, jcfg.vocab_size)
        want, jcache = jt.forward(jp, jnp.asarray(toks), jcfg, cache=jc,
                                  pos_offset=jnp.asarray(_POS))
        got, tcache = tt.forward(tp, torch.from_numpy(toks), tcfg,
                                 cache=tc, pos_offset=torch.from_numpy(_POS),
                                 attn_impl=attn_impl)
        assert got.shape == want.shape
        _close(got.numpy()[_VALID], np.asarray(want)[_VALID])
        # Every pool page but the trash block agrees: f32 pages within
        # the logits' tolerance, int8 codes and their scales (in the
        # port's unpadded layout) as _close_int8 states.
        hkv = jcfg.n_kv_heads
        for k in ("pool_k", "pool_v"):
            if int8:
                _close_int8(tcache[k][:, :-1], jcache[k][:, :-1],
                            tcache[k + "_scale"][:, :-1],
                            np.asarray(jcache[k + "_scale"])[:, :-1, :hkv])
            else:
                _close(tcache[k][:, :-1], jcache[k][:, :-1])

    @pytest.mark.parametrize("name", ["tiny", "llama"])
    def test_int8_paged_decode_vs_jax(self, name):
        """The paged S=1 branch over an int8 pool: quantize-on-write of
        the new row and the dequantized read."""
        from tpushare.models import quant as jq
        from tpushare_torch.models import quant as tq
        jcfg, jp, tcfg, tp = _pair(name, seed=9)
        L, nb, bs = jcfg.n_layers, 16, 4
        rng = np.random.default_rng(10)
        shape = (L, nb, bs, jcfg.n_kv_heads, jcfg.head_dim)
        (qk, sk), (qv, sv) = (tq.kv_quantize(torch.from_numpy(
            rng.normal(size=shape).astype(np.float32))) for _ in range(2))
        sk, sv = (tq.scales_to_pool_layout(x) for x in (sk, sv))
        toks = _tokens(11, 6, 1, jcfg.vocab_size)
        want, jcache = jt.forward(
            jp, jnp.asarray(toks), jcfg,
            cache={"pool_k": jnp.asarray(qk.numpy()),
                   "pool_v": jnp.asarray(qv.numpy()),
                   "pool_k_scale": jnp.asarray(_jax_scale_pages(sk.numpy())),
                   "pool_v_scale": jnp.asarray(_jax_scale_pages(sv.numpy())),
                   "table": jnp.asarray(_TABLE),
                   "active": jnp.asarray(_ACTIVE)},
            pos_offset=jnp.asarray(_POS))
        got, tcache = tt.forward(
            tp, torch.from_numpy(toks), tcfg,
            cache={"pool_k": qk, "pool_v": qv, "pool_k_scale": sk,
                   "pool_v_scale": sv, "table": torch.from_numpy(_TABLE),
                   "active": torch.from_numpy(_ACTIVE)},
            pos_offset=torch.from_numpy(_POS))
        valid = _VALID[:, 0]
        _close(got.numpy()[valid], np.asarray(want)[valid])
        for k in ("pool_k", "pool_v"):
            _close_int8(tcache[k][:, :-1], jcache[k][:, :-1],
                        tcache[k + "_scale"][:, :-1],
                        np.asarray(jcache[k + "_scale"])[:, :-1,
                                                         :jcfg.n_kv_heads])


class TestInt8AndHooks:
    @pytest.mark.parametrize("name", ["tiny", "gemma2"])
    def test_dense_scalar_offset_int8_rows(self, name):
        """Admission into an int8 row cache (quant.init_cache_q8): two
        chunks and a clamped write, codes and scales as JAX's."""
        from tpushare.models import quant as jq
        from tpushare_torch.models import quant as tq
        jcfg, jp, tcfg, tp = _pair(name, seed=12)
        toks = _tokens(13, 1, 20, jcfg.vocab_size)
        jc = jq.init_cache_q8(jcfg, 1, 24)
        tc = tq.init_cache_q8(tcfg, 1, 24, device="cpu")
        for lo, hi in ((0, 8), (8, 16), (20, 24)):
            piece = toks[:, lo:hi] if hi <= 20 else toks[:, 12:16]
            want, jc = jt.forward(jp, jnp.asarray(piece), jcfg, cache=jc,
                                  pos_offset=lo)
            got, tc = tt.forward(tp, torch.from_numpy(piece), tcfg,
                                 cache=tc, pos_offset=lo)
            _close(got, want)
            for k in ("k", "v"):
                _close_int8(tc[k], jc[k], tc[k + "_scale"], jc[k + "_scale"])

    @pytest.mark.parametrize("name", ["tiny", "llama"])
    def test_layers_hook_dequant(self, name):
        """forward over a quantize_params tree with dequant_hook: the
        int8-self draft's forward."""
        from tpushare.models import quant as jq
        from tpushare_torch.models import quant as tq
        jcfg, jp, tcfg, _ = _pair(name, seed=14)
        jqp = jq.quantize_params(jp, jcfg)
        tqp = bridge.params_from_jax(jqp, device="cpu")
        toks = _tokens(15, 2, 9, jcfg.vocab_size)
        want, _ = jt.forward(jqp, jnp.asarray(toks), jcfg,
                             layers_hook=jq.dequant_hook(jcfg))
        got, _ = tt.forward(tqp, torch.from_numpy(toks), tcfg,
                            layers_hook=tq.dequant_hook(tcfg))
        _close(got, want)


class TestDenseRagged:
    """The dense ragged branches over a row cache: S = 1 (continuous-
    batching decode, through flash_decode's plain version or the masked
    reference) and S > 1 (the fused tick), bf16/f32 or int8 rows. Row 2
    sits near max_len: its writes past it must be DROPPED (mode="drop"
    in the reference), never clamped onto live rows."""

    @pytest.mark.parametrize("int8", [False, True])
    @pytest.mark.parametrize("S", [1, 3])
    @pytest.mark.parametrize("name", ["tiny", "gemma2"])
    @pytest.mark.parametrize("attn_impl", ["auto", "reference"])
    def test_vs_jax(self, name, S, int8, attn_impl):
        from tpushare_torch.models import quant as tq
        jcfg, jp, tcfg, tp = _pair(name, seed=16)
        L, B, M = jcfg.n_layers, 4, 16
        rng = np.random.default_rng(17)
        shape = (L, B, M, jcfg.n_kv_heads, jcfg.head_dim)
        rows = {k: rng.normal(size=shape).astype(np.float32)
                for k in ("k", "v")}
        if int8:
            tc = {}
            for k in ("k", "v"):
                tc[k], tc[k + "_scale"] = tq.kv_quantize(
                    torch.from_numpy(rows[k]))
        else:
            tc = {k: torch.from_numpy(v.copy()) for k, v in rows.items()}
        jc = {k: jnp.asarray(v.numpy()) for k, v in tc.items()}
        pos = np.array([0, 7, 15 if S == 1 else 14, 5], np.int32)
        toks = _tokens(18, B, S, jcfg.vocab_size)
        want, jcache = jt.forward(jp, jnp.asarray(toks), jcfg, cache=jc,
                                  pos_offset=jnp.asarray(pos))
        got, tcache = tt.forward(tp, torch.from_numpy(toks), tcfg, cache=tc,
                                 pos_offset=torch.from_numpy(pos),
                                 attn_impl=attn_impl)
        assert got.shape == want.shape
        _close(got, want)
        for k in ("k", "v"):
            if int8:
                _close_int8(tcache[k], jcache[k], tcache[k + "_scale"],
                            jcache[k + "_scale"])
            else:
                _close(tcache[k], jcache[k])

    def test_write_past_max_len_is_dropped(self):
        """Every position of a row at or past max_len: nothing moves."""
        rows = torch.arange(2 * 5 * 3, dtype=torch.float32).reshape(2, 5, 3)
        before = rows.clone()
        vals = -torch.ones((2, 3, 3))
        tt.drop_write(rows, torch.tensor([[3, 4, 5], [5, 6, 7]]), vals)
        assert torch.equal(rows[1], before[1])
        assert torch.equal(rows[0, :3], before[0, :3])
        assert torch.equal(rows[0, 3:], -torch.ones((2, 3)))


class TestPrefillHelpers:
    @pytest.mark.parametrize("name", ["tiny", "gemma2"])
    def test_prefill_chunked_and_decode_step(self, name):
        jcfg, jp, tcfg, tp = _pair(name, seed=19)
        toks = _tokens(20, 2, 11, jcfg.vocab_size)
        want, jc = jt.prefill(jp, jnp.asarray(toks), jcfg, max_len=16)
        got, tc = tt.prefill(tp, torch.from_numpy(toks), tcfg, max_len=16)
        _close(got, want)
        _close(tc["k"], jc["k"])
        want, jc2 = jt.chunked_prefill(jp, jnp.asarray(toks), jcfg,
                                       max_len=16, chunk=4)
        got, tc2 = tt.chunked_prefill(tp, torch.from_numpy(toks), tcfg,
                                      max_len=16, chunk=4)
        _close(got, want)
        _close(tc2["v"], jc2["v"])
        tok = _tokens(21, 2, 1, jcfg.vocab_size)
        want, _ = jt.decode_step(jp, jnp.asarray(tok), jcfg, jc, 11)
        got, _ = tt.decode_step(tp, torch.from_numpy(tok), tcfg, tc, 11)
        _close(got, want)


class TestRefusals:
    def test_unported_branches_name_their_roadmap_item(self):
        cfg = tt.tiny()
        tp = tt.init_params(0, cfg, device="cpu")
        tok = torch.zeros((2, 3), dtype=torch.int64)
        dense = tt.init_cache(cfg, 2, 8, device="cpu")
        # The dense ragged branch is ported (ROADMAP A3 done): it runs.
        logits, _ = tt.forward(tp, tok, cfg, cache=dense,
                               pos_offset=torch.zeros(2, dtype=torch.int32))
        assert logits.shape == (2, 3, cfg.vocab_size)
        pool = torch.zeros((cfg.n_layers, 6, 4, 2, 32))
        paged = {"pool_k": pool, "pool_v": pool,
                 "table": torch.zeros((2, 2), dtype=torch.int32)}
        with pytest.raises(ValueError, match="scale leaves"):
            tt.forward(tp, tok, cfg, cache=dict(
                paged, pool_k=pool.to(torch.int8)),
                pos_offset=torch.zeros(2, dtype=torch.int32))
        with pytest.raises(NotImplementedError, match="ROADMAP A10"):
            tt.forward(tp, tok, cfg, pctx=tt.ParallelCtx(tp="tp"))
        # mlora_idx without a bank is ignored, as in the reference.
        assert torch.equal(tt.forward(tp, tok, cfg, mlora_idx=torch.zeros(
            2, dtype=torch.int64))[0], tt.forward(tp, tok, cfg)[0])
        with pytest.raises(ValueError, match="paged cache"):
            tt.forward(tp, tok[:, :1], cfg, cache=paged, pos_offset=0)
