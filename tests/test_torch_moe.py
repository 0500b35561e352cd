"""The port's MoE family (tpushare_torch.models.moe, with the int8 expert
path of ops/q8_expert.py) against the JAX package's, on the CPU in f32.

Weights come from a JAX ``moe.init_params`` tree (layer matrices x4, so
routing and greedy streams move every tick), bridged with
``bridge.params_from_jax``. ``moe.forward`` is held to JAX's on every
cache branch (no cache, prefill into rows, ragged rows at S = 1 and
S > 1 with a write past max_len, paged S = 1 and S > 1), for dense and
grouped capacity dispatch, with full-precision weights and with a
``quantize_params`` tree under ``fused_expert_hook`` (the fused kernel's
plain version here). f32 logits agree within 5e-5 of the largest
|logit| (the libraries sum in different orders, nothing else). The
slot servers (``MoESlotServer``, and ``PagedSlotServer`` with
``forward_fn=moe.paged_forward``) must give EQUAL greedy streams to the
JAX servers through plain, prefix-hit, chunked, fused and evict /
re-admit scenarios. Also: the quantizer on expert stacks, the bridge of
a quantized MoE tree, routing ties, the config conversion, one fetch
per tick, and the options that refuse.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.models import convert as jconvert
from tpushare.models import moe as jm
from tpushare.models import paged as jpaged
from tpushare.models import quant as jq

from tpushare_torch.models import bridge, convert, paged
from tpushare_torch.models import moe as tm
from tpushare_torch.models import quant as tq
from tests.test_torch_paged import _unaliased, count_fetches

REL = 5e-5
# fused_expert_hook vs dequant_hook on one int8 tree: the JAX test's
# own documented tolerance (tests/test_q8_expert.py LOGITS_TOL): scale
# after the f32 dot vs W*s rounded to cfg.dtype before it.
LOGITS_TOL = dict(rtol=2e-4, atol=2e-4)
DISPATCH = {"dense": None, "capacity": 1.5}


def _pair(capacity_factor=None, seed=0):
    jcfg = jm.tiny(remat=False, capacity_factor=capacity_factor)
    jp = jm.init_params(jax.random.PRNGKey(seed), jcfg)
    jp = dict(jp, layers={k: v * 4.0 if v.ndim >= 3 else v
                          for k, v in jp["layers"].items()})
    return jcfg, jp, bridge.moe_config_from_jax(jcfg), \
        bridge.params_from_jax(jp, device="cpu")


def _quantized(jcfg, jp):
    """(JAX int8 tree, its port bridge, JAX hook, port hook)."""
    jqp = jq.quantize_params(jp, jcfg)
    tcfg = bridge.moe_config_from_jax(jcfg)
    return (jqp, bridge.params_from_jax(jqp, device="cpu"),
            jq.fused_expert_hook(jcfg), tq.fused_expert_hook(tcfg))


def _close_rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * np.abs(want).max())


def _tokens(seed, B, S, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, S))


class TestQuantizeAndBridge:
    def test_expert_stacks_quantize_router_stays_fp(self):
        """The port's quantize_params on a moe.tiny() tree equals JAX's:
        #q8 leaves exactly, #scale leaves to 1e-7 relative, [L, E, 1,
        Out] scales for the rank-4 expert stacks; the router stays full
        precision."""
        jcfg, jp, tcfg, tp = _pair()
        jqp = jq.quantize_params(jp, jcfg)
        tqp = tq.quantize_params(tp, tcfg)
        L, E, Dm, F = (jcfg.n_layers, jcfg.n_experts, jcfg.d_model,
                       jcfg.d_ff)
        assert set(tqp["layers"]) == set(jqp["layers"])
        assert tuple(tqp["layers"]["w_gate#scale"].shape) == (L, E, 1, F)
        assert tuple(tqp["layers"]["w_down#scale"].shape) == (L, E, 1, Dm)
        assert tuple(tqp["layers"]["wq#scale"].shape) == (L, 1, jcfg.q_dim)
        for k, v in tqp["layers"].items():
            want = np.asarray(jqp["layers"][k])
            if k.endswith("#q8"):
                assert v.dtype == torch.int8
                np.testing.assert_array_equal(v.numpy(), want)
            elif k.endswith("#scale"):
                np.testing.assert_allclose(v.numpy(), want, rtol=1e-7,
                                           atol=0)
        assert tqp["layers"]["router"].dtype == tp["layers"]["router"].dtype
        assert "w_gate" not in tqp["layers"]

    def test_bridge_keeps_int8_expert_leaves(self):
        jcfg, jp, _, _ = _pair()
        jqp, tqp, _, _ = _quantized(jcfg, jp)
        for k, v in jqp["layers"].items():
            got = tqp["layers"][k]
            assert tuple(got.shape) == v.shape
            if k.endswith("#q8"):
                assert got.dtype == torch.int8
                np.testing.assert_array_equal(got.numpy(), np.asarray(v))
            elif k.endswith("#scale"):
                assert got.dtype == torch.float32
        assert tqp["layers"]["w_gate#q8"].ndim == 4

    def test_hooks_pass_expert_leaves_through(self):
        jcfg, jp, tcfg, _ = _pair()
        _, tqp, _, hook = _quantized(jcfg, jp)
        layer = {k: v[0] for k, v in tqp["layers"].items()}
        fused = hook(layer)
        assert fused["w_gate#q8"].dtype == torch.int8
        assert "w_gate" not in fused and "wq#q8" not in fused
        wide = tq.dequant_expert_leaves(layer, tcfg.dtype)
        ref = tq.dequant_hook(tcfg)(layer)
        for k in ("w_gate", "w_down", "wq"):
            assert torch.equal(wide[k], ref[k])
        assert tq.fused_expert_hook(tcfg) is hook        # memoized


def _forward_case(branch, jcfg, jp, tcfg, tp, jhook, thook, attn_impl):
    """Run one forward branch through both packages; returns (got, want,
    rows whose logits are a served token's)."""
    kw_j = dict(layers_hook=jhook)
    kw_t = dict(layers_hook=thook, attn_impl=attn_impl)
    L, Hkv, Dh = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
    rng = np.random.default_rng(41)
    if branch == "no_cache":
        toks = _tokens(42, 2, 9)
        want, _ = jm.forward(jp, jnp.asarray(toks), jcfg, **kw_j)
        got, _ = tm.forward(tp, torch.from_numpy(toks), tcfg, **kw_t)
        return got, want, None
    if branch == "prefill_rows":
        toks = _tokens(43, 1, 12)
        jc, tc = jm.init_cache(jcfg, 1, 16), tm.init_cache(tcfg, 1, 16,
                                                           device="cpu")
        outs = []
        for lo, hi in ((0, 8), (8, 12)):
            want, _, jc = jm.forward(jp, jnp.asarray(toks[:, lo:hi]), jcfg,
                                     cache=jc, pos_offset=lo, **kw_j)
            got, _, tc = tm.forward(tp, torch.from_numpy(toks[:, lo:hi]),
                                    tcfg, cache=tc, pos_offset=lo, **kw_t)
            outs.append((got, want))
        _close_rel(tc["k"], jc["k"])
        return (torch.cat([g for g, _ in outs], 1),
                np.concatenate([np.asarray(w) for _, w in outs], 1), None)
    if branch.startswith("ragged"):
        S = 1 if branch == "ragged_s1" else 3
        shape = (L, 4, 16, Hkv, Dh)
        rows = {k: rng.normal(size=shape).astype(np.float32)
                for k in ("k", "v")}
        pos = np.array([0, 7, 15 if S == 1 else 14, 5], np.int32)
        toks = _tokens(44, 4, S)
        want, _, jc = jm.forward(
            jp, jnp.asarray(toks), jcfg,
            cache={k: jnp.asarray(v) for k, v in rows.items()},
            pos_offset=jnp.asarray(pos), **kw_j)
        got, _, tc = tm.forward(
            tp, torch.from_numpy(toks), tcfg,
            cache={k: torch.from_numpy(v.copy()) for k, v in rows.items()},
            pos_offset=torch.from_numpy(pos), **kw_t)
        _close_rel(tc["k"], jc["k"])       # row 2's spill was dropped
        return got, want, None
    S = 1 if branch == "paged_s1" else 3
    nb, bs = 16, 4
    shape = (L, nb, bs, Hkv, Dh)
    pk = rng.normal(size=shape).astype(np.float32)
    pv = rng.normal(size=shape).astype(np.float32)
    table = np.array([[0, 3, 11, -1, -1], [5, 1, 2, 12, -1],
                      [0, 7, -1, -1, -1], [8, 9, 10, 4, 13],
                      [6, -1, -1, -1, -1]], np.int32)
    pos = np.array([6, 9, 5, 17 if S == 3 else 19, 2], np.int32)
    active = np.array([True, True, True, True, False])
    toks = _tokens(45, 5, S)
    want, _, jc = jm.forward(
        jp, jnp.asarray(toks), jcfg,
        cache={"pool_k": jnp.asarray(pk), "pool_v": jnp.asarray(pv),
               "table": jnp.asarray(table), "active": jnp.asarray(active)},
        pos_offset=jnp.asarray(pos), **kw_j)
    got, _, tc = tm.forward(
        tp, torch.from_numpy(toks), tcfg,
        cache={"pool_k": torch.from_numpy(pk.copy()),
               "pool_v": torch.from_numpy(pv.copy()),
               "table": torch.from_numpy(table),
               "active": torch.from_numpy(active)},
        pos_offset=torch.from_numpy(pos), **kw_t)
    _close_rel(tc["pool_k"][:, :-1], jc["pool_k"][:, :-1])
    valid = np.ones((5, S), bool)
    valid[4] = False                        # inactive: writes to trash
    if S == 3:
        valid[3, 2] = False                 # position 19 ok, 20 = capacity
    return got, want, valid


BRANCHES = ["no_cache", "prefill_rows", "ragged_s1", "ragged_s3",
            "paged_s1", "paged_s3"]


class TestForwardParity:
    @pytest.mark.parametrize("branch", BRANCHES)
    @pytest.mark.parametrize("dispatch", list(DISPATCH))
    @pytest.mark.parametrize("weights", ["fp", "int8_fused"])
    def test_vs_jax(self, branch, dispatch, weights):
        jcfg, jp, tcfg, tp = _pair(DISPATCH[dispatch], seed=1)
        jhook = thook = None
        if weights == "int8_fused":
            jp, tp, jhook, thook = _quantized(jcfg, jp)
        got, want, valid = _forward_case(branch, jcfg, jp, tcfg, tp, jhook,
                                         thook, "auto")
        if valid is not None:
            got, want = got.numpy()[valid], np.asarray(want)[valid]
        _close_rel(got, want)

    @pytest.mark.parametrize("branch", ["ragged_s1", "paged_s3"])
    def test_reference_attention_matches(self, branch):
        jcfg, jp, tcfg, tp = _pair(seed=2)
        got, want, valid = _forward_case(branch, jcfg, jp, tcfg, tp, None,
                                         None, "reference")
        if valid is not None:
            got, want = got.numpy()[valid], np.asarray(want)[valid]
        _close_rel(got, want)

    def test_last_logit_only_and_aux(self):
        jcfg, jp, tcfg, tp = _pair(seed=3)
        toks = _tokens(46, 2, 7)
        want, jaux = jm.forward(jp, jnp.asarray(toks), jcfg)
        got, taux = tm.forward(tp, torch.from_numpy(toks), tcfg,
                               last_logit_only=True)
        _close_rel(got[:, 0], np.asarray(want)[:, -1])
        assert abs(float(taux) - float(jaux)) < 1e-5

    @pytest.mark.parametrize("dispatch", list(DISPATCH))
    def test_fused_hook_vs_dequant_hook(self, dispatch):
        jcfg, jp, tcfg, _ = _pair(DISPATCH[dispatch], seed=4)
        _, tqp, _, fused = _quantized(jcfg, jp)
        toks = torch.from_numpy(_tokens(47, 2, 9))
        a, _ = tm.forward(tqp, toks, tcfg, layers_hook=fused)
        b, _ = tm.forward(tqp, toks, tcfg,
                          layers_hook=tq.dequant_hook(tcfg))
        np.testing.assert_allclose(a.numpy(), b.numpy(), **LOGITS_TOL)


class TestRouting:
    def test_ties_go_to_the_lower_index(self):
        """jax.lax.top_k breaks ties toward the lower index; the port
        pins the same rule (torch.topk promises none)."""
        probs = np.array([[[0.1, 0.3, 0.3, 0.3]], [[0.25, 0.25, 0.25,
                                                    0.25]]], np.float32)
        jw, ji = jax.lax.top_k(jnp.asarray(probs), 2)
        tw, ti = tm.top_k_lower_index(torch.from_numpy(probs), 2)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(ti.numpy()[:, 0], [[1, 2], [0, 1]])
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw))

    def test_tied_router_in_a_forward(self, monkeypatch):
        """A router with two identical expert columns: every token ties
        between them, and both packages send it to the same experts."""
        jcfg, jp, tcfg, _ = _pair(seed=5)
        r = np.asarray(jp["layers"]["router"]).copy()
        r[..., 3] = r[..., 1]
        jp = dict(jp, layers=dict(jp["layers"], router=jnp.asarray(r)))
        tp = bridge.params_from_jax(jp, device="cpu")
        toks = _tokens(48, 2, 9)
        seen, top_k = [], tm.top_k_lower_index

        def recording_top_k(probs, k):
            out = top_k(probs, k)
            seen.append(out[1])
            return out

        monkeypatch.setattr(tm, "top_k_lower_index", recording_top_k)
        got, _ = tm.forward(tp, torch.from_numpy(toks), tcfg)
        picks = torch.stack(seen)
        want, _ = jm.forward(jp, jnp.asarray(toks), jcfg)
        _close_rel(got, want)
        # Expert 1 always wins its tie with 3: 3 is picked only beside
        # 1, and after it.
        with3 = picks[(picks == 3).any(-1)]
        assert len(with3) and (with3 == torch.tensor([1, 3])).all()

    def test_route_buffers_and_capacity(self):
        cfg = tm.tiny(capacity_factor=1.0)
        assert tm.expert_capacity(10, cfg) == 5
        top_i = torch.tensor([[0, 1], [0, 2], [0, 1], [3, 0]])
        top_w = torch.full((4, 2), 0.5)
        buf, wbuf = tm._route_buffers(top_w, top_i, 4, 4, 2)
        jbuf, jwbuf = jm._route_buffers(jnp.asarray(top_w.numpy()),
                                        jnp.asarray(top_i.numpy()), 4, 4, 2)
        np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
        np.testing.assert_array_equal(wbuf.numpy(), np.asarray(jwbuf))


def _prompts(vocab=256):
    rng = np.random.default_rng(51)
    a = rng.integers(0, vocab, 13)
    d = rng.integers(0, vocab, 11)
    return {"a": a, "b": rng.integers(0, vocab, 6),
            "c": np.concatenate([a[:9], rng.integers(0, vocab, 3)]),
            "d": d, "e": np.concatenate([d[:7], rng.integers(0, vocab, 5)]),
            "f": rng.integers(0, vocab, 10)}


def _scenario(srv, prompts, wrap):
    """Plain admits, a prefix hit, evict and re-admit (another hit), a
    serial chunked admission between decode ticks, then fused ticks: one
    budget-capped and mixed with a serial chunk, one to the end."""
    log = []

    def steps(n):
        for _ in range(n):
            log.append(("step", sorted(srv.step().items())))

    def admit(key):
        slot = srv.admit(wrap(prompts[key]))
        log.append(("admit", key, slot, srv.last_cached_len))

    def fused(slot, cap=None):
        while slot in srv._admissions:
            log.append(("fused", slot, sorted(srv.step(
                prefill_work=slot, max_chunk_tokens=cap).items())))

    admit("b")
    admit("a")
    steps(3)
    admit("c")
    steps(3)
    srv.evict(1)
    log.append(("evict", 1))
    admit("a")
    steps(2)
    slot = srv.admit_start(wrap(prompts["d"]), chunk_tokens=4)
    while (tok := srv.admit_step(slot)) is None:
        log.append(("step", sorted(srv.step().items())))
    log.append(("chunked", slot, tok))
    steps(2)
    srv.evict(0)
    slot = srv.admit_start(wrap(prompts["e"]), chunk_tokens=4)
    log.append(("start", slot, srv.last_cached_len))
    log.append(("fused", slot, sorted(srv.step(
        prefill_work=slot, max_chunk_tokens=2).items())))
    log.append(("serial", slot, srv.admit_step(slot)))
    fused(slot)
    srv.evict(2)
    slot = srv.admit_start(wrap(prompts["f"]), chunk_tokens=4)
    fused(slot)
    steps(3)
    return log


SERVERS = {
    "rows": {},
    "rows-capacity": {"capacity_factor": 1.5},
    "rows-int8-fused": {"int8": True},
    "paged": {"paged": True},
    "paged-int8-fused": {"paged": True, "int8": True},
}


@pytest.fixture(scope="module", params=list(SERVERS))
def logs(request):
    opts = dict(SERVERS[request.param])
    jcfg, jp, tcfg, tp = _pair(opts.pop("capacity_factor", None), seed=6)
    jkw, tkw = {"prefix_cache": True}, {"prefix_cache": True}
    if opts.get("int8"):
        jp, tp, jkw["layers_hook"], tkw["layers_hook"] = _quantized(jcfg, jp)
    if opts.get("paged"):
        kw = dict(n_slots=4, n_blocks=64, block_size=4)
        jsrv = jpaged.PagedSlotServer(jp, jcfg, forward_fn=jm.paged_forward,
                                      **kw, **jkw)
        tsrv = paged.PagedSlotServer(tp, tcfg, forward_fn=tm.paged_forward,
                                     device="cpu", **kw, **tkw)
    else:
        jsrv = jm.MoESlotServer(jp, jcfg, n_slots=4, max_len=48, **jkw)
        tsrv = tm.MoESlotServer(tp, tcfg, n_slots=4, max_len=48,
                                device="cpu", **tkw)
    prompts = _prompts()
    jlog = _scenario(_unaliased(jsrv), prompts,
                     lambda p: jnp.asarray(p, jnp.int32))
    tlog = _scenario(tsrv, prompts, lambda p: p)
    return jlog, tlog, jsrv, tsrv


class TestServerParity:
    def test_token_streams_equal(self, logs):
        jlog, tlog, _, _ = logs
        kinds = [e[0] for e in tlog]
        assert kinds.count("fused") >= 4 and "serial" in kinds
        hits = [e[3] for e in tlog if e[0] == "admit"]
        assert hits[0] == 0 and max(hits) > 0          # a prefix hit
        assert tlog == jlog

    def test_counters_agree(self, logs):
        _, _, jsrv, tsrv = logs
        assert tsrv.prefix_hit_tokens == jsrv.prefix_hit_tokens > 0
        assert tsrv.device_fetches == jsrv.device_fetches
        np.testing.assert_array_equal(tsrv.active, jsrv.active)
        if isinstance(tsrv, tm.MoESlotServer):
            np.testing.assert_array_equal(tsrv._lengths_np,
                                          np.asarray(jsrv.lengths))
        else:
            np.testing.assert_array_equal(tsrv.cache.host_lengths(),
                                          np.asarray(jsrv.cache.lengths))
            assert sorted(tsrv.cache.free) == sorted(jsrv.cache.free)

    def test_chunked_matches_whole_admit(self):
        """The TestMoEChunkedAdmit shape: 13 tokens in 4-token chunks
        write the same row as a whole admission."""
        jcfg, jp, tcfg, tp = _pair(seed=7)
        prompt = np.random.default_rng(21).integers(0, 256, 13)
        whole = tm.MoESlotServer(tp, tcfg, n_slots=2, max_len=32,
                                 device="cpu")
        sw = whole.admit(prompt)
        chunked = tm.MoESlotServer(tp, tcfg, n_slots=2, max_len=32,
                                   device="cpu")
        sc = chunked.admit_start(prompt, chunk_tokens=4)
        steps = 0
        while chunked.admit_step(sc) is None:
            steps += 1
        assert steps == 3 and chunked.admitting_count == 0
        a = [whole.step()[sw] for _ in range(6)]
        b = [chunked.step()[sc] for _ in range(6)]
        assert a == b


class TestTickContract:
    @pytest.mark.parametrize("server", ["rows", "paged"])
    def test_one_fetch_per_tick_and_fused_tick(self, server):
        jcfg, jp, tcfg, tp = _pair(seed=8)
        _, tqp, _, hook = _quantized(jcfg, jp)
        if server == "rows":
            srv = tm.MoESlotServer(tqp, tcfg, n_slots=3, max_len=40,
                                   layers_hook=hook, device="cpu")
        else:
            srv = paged.PagedSlotServer(tqp, tcfg, n_slots=3, n_blocks=32,
                                        block_size=4, layers_hook=hook,
                                        forward_fn=tm.paged_forward,
                                        device="cpu")
        srv.admit(np.arange(6))
        slot = srv.admit_start(np.arange(20, 31), chunk_tokens=4)
        counts = []
        with count_fetches(counts):
            for _ in range(3):
                counts.append(0)
                assert srv.step()
            while slot in srv._admissions:
                counts.append(0)
                srv.step(prefill_work=slot)
        assert counts == [1] * 6, counts
        assert srv.active[slot]


class TestConvert:
    MIXTRAL = dict(model_type="mixtral", vocab_size=32000, hidden_size=4096,
                   num_hidden_layers=32, num_attention_heads=32,
                   num_key_value_heads=8, intermediate_size=14336,
                   num_local_experts=8, num_experts_per_tok=2,
                   rope_theta=1e6, rms_norm_eps=1e-5, hidden_act="silu",
                   tie_word_embeddings=False, router_aux_loss_coef=0.02,
                   rope_scaling=None)

    def test_mixtral_fields_equal_jax(self):
        hf = types.SimpleNamespace(**self.MIXTRAL)
        got = convert.moe_config_from_hf(hf)
        want = bridge.moe_config_from_jax(jconvert.moe_config_from_hf(hf))
        assert got == want
        assert (got.d_ff, got.n_experts, got.top_k, got.head_dim) == (
            14336, 8, 2, 128)
        assert got.routing == "psum" and got.capacity_factor is None
        assert not got.tie_embeddings and got.dtype == torch.bfloat16

    def test_rope_scaling_and_refusals(self):
        rs = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
              "high_freq_factor": 4.0,
              "original_max_position_embeddings": 8192}
        hf = types.SimpleNamespace(**dict(self.MIXTRAL, rope_scaling=rs))
        assert convert.moe_config_from_hf(hf).rope_scaling == \
            jconvert.moe_config_from_hf(hf).rope_scaling
        with pytest.raises(NotImplementedError, match="mixtral"):
            convert.moe_config_from_hf(types.SimpleNamespace(
                **dict(self.MIXTRAL, model_type="llama")))
        with pytest.raises(NotImplementedError, match="hidden_act"):
            convert.moe_config_from_hf(types.SimpleNamespace(
                **dict(self.MIXTRAL, hidden_act="relu")))


class TestRefusals:
    def test_paged_forward_fn_rejects_kv_quant(self):
        """The reference's words for the dense-LM features a paged MoE
        server refuses: kv_quant and multi_lora."""
        jcfg, jp, tcfg, tp = _pair()
        for kw in ({"kv_quant": True}, {"multi_lora": {}}):
            with pytest.raises(ValueError, match="kv_quant or multi_lora"):
                paged.PagedSlotServer(tp, tcfg, n_slots=2, n_blocks=8,
                                      forward_fn=tm.paged_forward,
                                      device="cpu", **kw)
            with pytest.raises(ValueError, match="kv_quant or multi_lora"):
                jpaged.PagedSlotServer(jp, jcfg, n_slots=2, n_blocks=8,
                                       forward_fn=jm.paged_forward, **kw)

    @pytest.mark.parametrize("kw,item", [
        ({"mesh": object()}, "A10"),
        ({"param_specs": object()}, "A10"),
        ({"draft_param_specs": object()}, "A10"),
    ])
    def test_server_options(self, kw, item):
        _, _, tcfg, tp = _pair()
        with pytest.raises(NotImplementedError, match=item):
            tm.MoESlotServer(tp, tcfg, n_slots=2, max_len=8, device="cpu",
                             **kw)

    @pytest.mark.parametrize("routing", ["a2a", "dropless", "expert_choice"])
    def test_routings(self, routing):
        """Every single-card routing forwards, equal to the JAX
        package's at f32 (a2a without an ep axis is the psum math)."""
        jcfg = jm.tiny(remat=False, routing=routing)
        jp = jm.init_params(jax.random.PRNGKey(9), jcfg)
        tp = bridge.params_from_jax(jp, device="cpu")
        toks = _tokens(49, 2, 7)
        want, jaux = jm.forward(jp, jnp.asarray(toks), jcfg)
        got, taux = tm.forward(tp, torch.from_numpy(toks),
                               bridge.moe_config_from_jax(jcfg))
        _close_rel(got, want)
        assert abs(float(taux) - float(jaux)) < 1e-5

    def test_forward_and_entry_points(self):
        cfg = tm.tiny()
        tp = tm.init_params(0, cfg, device="cpu")
        tok = torch.zeros((1, 3), dtype=torch.int64)
        with pytest.raises(NotImplementedError, match="A10"):
            tm.forward(tp, tok, cfg, ep_axis="ep")
        with pytest.raises(NotImplementedError, match="A12"):
            tm.generate(tp, tok, cfg)
        with pytest.raises(NotImplementedError, match="A12"):
            tm.lm_loss(tp, tok, cfg)
        with pytest.raises(ValueError, match="adapter"):
            tm.paged_forward(tp, tok, cfg, mlora_idx=torch.zeros(1))
