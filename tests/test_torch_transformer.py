"""Parity of the port's transformer (tpushare_torch.models.transformer)
with the JAX package's, on the CPU in f32, weights carried across by
``bridge.params_from_jax``.

Covers forward's three ported branches (no cache, dense scalar offset,
paged S=1), the configs' spots where the two frameworks round
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


class TestRefusals:
    def test_unported_branches_name_their_roadmap_item(self):
        cfg = tt.tiny()
        tp = tt.init_params(0, cfg, device="cpu")
        tok = torch.zeros((2, 3), dtype=torch.int64)
        dense = tt.init_cache(cfg, 2, 8, device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP A3"):
            tt.forward(tp, tok, cfg, cache=dense,
                       pos_offset=torch.zeros(2, dtype=torch.int32))
        pool = torch.zeros((cfg.n_layers, 6, 4, 2, 32))
        paged = {"pool_k": pool, "pool_v": pool,
                 "table": torch.zeros((2, 2), dtype=torch.int32)}
        with pytest.raises(NotImplementedError, match="ROADMAP A3"):
            tt.forward(tp, tok, cfg, cache=paged,
                       pos_offset=torch.zeros(2, dtype=torch.int32))
        with pytest.raises(NotImplementedError, match="ROADMAP A3"):
            tt.forward(tp, tok, cfg, cache=dict(dense, k_scale=None))
        with pytest.raises(NotImplementedError, match="ROADMAP A10"):
            tt.forward(tp, tok, cfg, pctx=object())
        with pytest.raises(NotImplementedError, match="ROADMAP A9"):
            tt.forward(tp, tok, cfg, mlora_idx=torch.zeros(2))
        with pytest.raises(NotImplementedError, match="ROADMAP A6"):
            tt.forward(tp, tok, cfg, layers_hook=lambda x: x)
        with pytest.raises(ValueError, match="paged cache"):
            tt.forward(tp, tok[:, :1], cfg, cache=paged, pos_offset=0)
