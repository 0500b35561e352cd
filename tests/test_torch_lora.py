"""The port's LoRA adapters and multi-LoRA serving (tpushare_torch.models.
lora, ``transformer.forward``'s adapter path, ``serving.MultiLoraSlots``,
both slot servers' ``multi_lora``, the engine's ``adapter`` field)
against the JAX package's, on the CPU in f32.

Adapter trees are the JAX package's (``init_lora`` with B drawn non-zero
so every adapter moves the logits), stacked into a bank and bridged with
``bridge.adapters_from_jax``. Logits within 5e-5 of the largest |logit|
(the libraries sum in different orders, nothing else); int8 KV codes as
``test_torch_transformer._close_int8`` states; greedy streams, prefix
hits, status codes and fetch counts EQUAL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.cli import serve as jserve
from tpushare.models import lora as jl
from tpushare.models import paged as jpaged
from tpushare.models import quant as jq
from tpushare.models import serving as jserving
from tpushare.models import transformer as jt

from tpushare_torch.cli import serve as tserve
from tpushare_torch.models import bridge, lora
from tpushare_torch.models import paged as tpaged
from tpushare_torch.models import quant as tq
from tpushare_torch.models import serving as tserving
from tpushare_torch.models import transformer as tt
from tests.test_torch_paged import _unaliased, count_fetches
from tests.test_torch_serve import (HTTP_TIMEOUT, JCFG, _drive, _engine,
                                    _post, _request, _shutdown)
from tests.test_torch_transformer import (_ACTIVE, _POS, _TABLE, _VALID,
                                          _close_int8, _jax_scale_pages)

REL = 5e-5


def _close_rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * np.abs(want).max())


def _jax_adapter(jcfg, seed, rank=4, targets=jl.DEFAULT_TARGETS):
    """A JAX init_lora tree with B drawn too (the init's B is zero)."""
    ad = jl.init_lora(jax.random.PRNGKey(seed), jcfg, rank, targets)
    rng = np.random.default_rng(seed)
    return {n: {"a": ab["a"], "b": jnp.asarray(rng.normal(
        size=ab["b"].shape).astype(np.float32) * 0.3)}
        for n, ab in ad.items()}


def _bank(jcfg, n=3, targets=jl.DEFAULT_TARGETS, seed=0):
    """(JAX adapters, JAX bank, port bank)."""
    ads = [_jax_adapter(jcfg, seed + i, targets=targets) for i in range(n)]
    jbank = jl.stack_adapters(ads)
    return ads, jbank, bridge.adapters_from_jax(jbank, device="cpu")


def _base(seed=0):
    jcfg = jt.tiny(remat=False)
    jp = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, bridge.config_from_jax(jcfg), \
        bridge.params_from_jax(jp, device="cpu")


class TestAdapters:
    def test_init_lora_shapes_and_zero_delta(self):
        """A [L, d_in, r] truncated-normal / sqrt(d_in), B [L, r, d_out]
        zeros: step 0 of a LoRA run is the base model bit for bit."""
        cfg = tt.tiny()
        gen = torch.Generator().manual_seed(0)
        ad = lora.init_lora(gen, cfg, 4, lora.LORA_TARGETS)
        for name in lora.LORA_TARGETS:
            d_in, d_out = lora._target_dims(cfg, name)
            assert tuple(ad[name]["a"].shape) == (cfg.n_layers, d_in, 4)
            assert tuple(ad[name]["b"].shape) == (cfg.n_layers, 4, d_out)
            assert not ad[name]["b"].any()
            a = ad[name]["a"] * d_in ** 0.5
            assert a.abs().max() <= 2.0 and a.std() > 0.5
        params = tt.init_params(1, cfg, device="cpu")
        toks = torch.arange(9)[None] % cfg.vocab_size
        base, _ = tt.forward(params, toks, cfg)
        hooked, _ = tt.forward(lora.lora_params(params, ad), toks, cfg,
                               layers_hook=lora.lora_hook(1.0))
        assert torch.equal(base, hooked)
        assert torch.equal(
            base, tt.forward(lora.merge_lora(params, ad), toks, cfg)[0])
        with pytest.raises(ValueError, match="unknown LoRA target"):
            lora.init_lora(gen, cfg, 4, ("wx",))

    @pytest.mark.parametrize("scale", [1.0, 0.5])
    def test_hook_and_merge_vs_jax(self, scale):
        jcfg, jp, tcfg, tp = _base(seed=1)
        jad = _jax_adapter(jcfg, 3, targets=jl.LORA_TARGETS)
        tad = bridge.adapters_from_jax(jad, device="cpu")
        toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 9))
        want, _ = jt.forward(jl.lora_params(jp, jad), jnp.asarray(toks), jcfg,
                             layers_hook=jl.lora_hook(scale))
        got, _ = tt.forward(lora.lora_params(tp, tad), torch.from_numpy(toks),
                            tcfg, layers_hook=lora.lora_hook(scale))
        _close_rel(got, want)
        jm_ = jl.merge_lora(jp, jad, scale)
        tm_ = lora.merge_lora(tp, tad, scale)
        for k in jl.LORA_TARGETS:
            np.testing.assert_allclose(tm_["layers"][k].numpy(),
                                       np.asarray(jm_["layers"][k]),
                                       rtol=1e-5, atol=1e-6)
        assert tm_["layers"]["ln1"] is tp["layers"]["ln1"]
        _close_rel(tt.forward(tm_, torch.from_numpy(toks), tcfg)[0], want)
        assert lora.lora_hook(scale) is lora.lora_hook(scale)

    def test_hook_composes_with_an_int8_base(self):
        """lora_hook(inner=dequant_hook): the int8 base widens first,
        the delta adds on top, as in the reference."""
        jcfg, jp, tcfg, tp = _base(seed=2)
        jad = _jax_adapter(jcfg, 4)
        tad = bridge.adapters_from_jax(jad, device="cpu")
        toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 7))
        want, _ = jt.forward(
            jl.lora_params(jq.quantize_params(jp, jcfg), jad),
            jnp.asarray(toks), jcfg,
            layers_hook=jl.lora_hook(1.0, inner=jq.dequant_hook(jcfg)))
        got, _ = tt.forward(
            lora.lora_params(tq.quantize_params(tp, tcfg), tad),
            torch.from_numpy(toks), tcfg,
            layers_hook=lora.lora_hook(1.0, inner=tq.dequant_hook(tcfg)))
        _close_rel(got, want)

    def test_bank_and_packing_vs_jax(self):
        jcfg, jp, tcfg, tp = _base()
        ads, jbank, tbank = _bank(jcfg, 3, jl.LORA_TARGETS)
        tads = [bridge.adapters_from_jax(a, device="cpu") for a in ads]
        stacked = lora.stack_adapters(tads)
        for n in jl.LORA_TARGETS:
            for k in ("a", "b"):
                assert tuple(stacked[n][k].shape) == jbank[n][k].shape
                np.testing.assert_array_equal(stacked[n][k].numpy(),
                                              np.asarray(jbank[n][k]))
                np.testing.assert_array_equal(tbank[n][k].numpy(),
                                              np.asarray(jbank[n][k]))
        assert lora.bank_size(stacked) == 3
        packed = lora.multi_lora_params(tp, stacked)
        assert packed["layers"]["_mlora"] is stacked
        assert packed["layers"]["wq"] is tp["layers"]["wq"]
        with pytest.raises(ValueError, match="at least one"):
            lora.stack_adapters([])
        with pytest.raises(ValueError, match="target sets"):
            lora.stack_adapters([tads[0], {"wq": tads[1]["wq"]}])
        with pytest.raises(ValueError, match="not a LoRA adapter tree"):
            bridge.adapters_from_jax({"wq": {"a": 1}})

    def test_left_out_pieces_name_their_item(self):
        """A bank on a mesh is the piece left out, refused as the
        reference refuses it; the adapters' spec tree (ROADMAP A10a)
        and LoRA training are ported (their parity:
        tests/test_torch_mesh.py, tests/test_torch_finetune.py)."""
        from tpushare_torch.parallel.mesh import ServingMesh
        mesh = ServingMesh({"tp": 2}, ["cpu"] * 2)
        mesh.rank = 0
        cfg = tt.tiny()
        bank = lora.stack_adapters([lora.init_lora(
            torch.Generator().manual_seed(1), cfg, 2)])
        with pytest.raises(ValueError, match="multi_lora"):
            tpaged.PagedSlotServer(tt.init_params(0, cfg, device="cpu"), cfg,
                                   n_slots=2, n_blocks=16, block_size=4,
                                   multi_lora=bank, mesh=mesh)
        assert set(lora.lora_param_specs(cfg)) == set(lora.DEFAULT_TARGETS)
        base = tt.init_params(0, cfg, device="cpu")
        ad = lora.init_lora(torch.Generator().manual_seed(0), cfg, 2)
        tok = torch.zeros((1, 5), dtype=torch.int64)
        assert torch.isfinite(lora.lora_loss(base, ad, tok, cfg))
        step = lora.make_lora_fit_step(base, cfg)
        assert step(ad, {}, tok)[1] == {}


def _mlora_inputs(jcfg, jp, tp, targets, seed=0, B=None):
    ads, jbank, tbank = _bank(jcfg, 3, targets, seed=seed)
    return (jl.multi_lora_params(jp, jbank),
            lora.multi_lora_params(tp, tbank), ads)


IDX = np.array([0, -1, 2, 1, -1, 0], np.int64)


class TestForwardAdapterPath:
    @pytest.mark.parametrize("scale", [1.0, 0.7])
    def test_delta_matches_the_merged_weights(self, scale):
        """TestMultiLora's check on the port: row i under adapter k is
        the merge_lora(base, adapter k) model's row; idx -1 the base
        model exactly."""
        jcfg, jp, tcfg, tp = _base(seed=5)
        _, tml, ads = _mlora_inputs(jcfg, jp, tp, jl.LORA_TARGETS)
        toks = torch.from_numpy(np.random.default_rng(6).integers(
            0, jcfg.vocab_size, (4, 8)))
        idx = torch.tensor([1, -1, 0, 2])
        got, _ = tt.forward(tml, toks, tcfg, mlora_idx=idx,
                            mlora_scale=scale)
        base, _ = tt.forward(tp, toks, tcfg)
        assert torch.equal(got[1], base[1])
        for row, k in ((0, 1), (2, 0), (3, 2)):
            merged = lora.merge_lora(tp, bridge.adapters_from_jax(
                ads[k], device="cpu"), scale)
            want, _ = tt.forward(merged, toks[row:row + 1], tcfg)
            np.testing.assert_allclose(got[row].numpy(), want[0].numpy(),
                                       rtol=2e-4, atol=2e-4)

    @pytest.mark.parametrize("branch", ["no_cache", "prefill_rows",
                                        "ragged_s1", "ragged_s3",
                                        "ragged_s1_int8", "paged_s1",
                                        "paged_s3", "paged_s1_int8",
                                        "paged_s3_int8"])
    def test_every_cache_branch_vs_jax(self, branch):
        """mlora_idx on each branch the reference allows: no cache, the
        dense scalar-offset prefill, ragged rows (S = 1, S > 1), paged
        S = 1 and S > 1, over f32 and int8 KV; every target adapted."""
        jcfg, jp, tcfg, tp = _base(seed=7)
        jml, tml, _ = _mlora_inputs(jcfg, jp, tp, jl.LORA_TARGETS, seed=8)
        rng = np.random.default_rng(9)
        L, Hkv, Dh = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
        int8 = branch.endswith("_int8")
        if branch == "no_cache":
            toks = rng.integers(0, jcfg.vocab_size, (3, 7))
            idx = IDX[:3]
            want, _ = jt.forward(jml, jnp.asarray(toks), jcfg,
                                 mlora_idx=jnp.asarray(idx, jnp.int32))
            got, _ = tt.forward(tml, torch.from_numpy(toks), tcfg,
                                mlora_idx=torch.from_numpy(idx))
            _close_rel(got, want)
            return
        if branch == "prefill_rows":
            toks = rng.integers(0, jcfg.vocab_size, (1, 12))
            idx = np.array([2], np.int64)
            jc, tc = (jt.init_cache(jcfg, 1, 16),
                      tt.init_cache(tcfg, 1, 16, device="cpu"))
            for lo, hi in ((0, 8), (8, 12)):
                want, jc = jt.forward(jml, jnp.asarray(toks[:, lo:hi]), jcfg,
                                      cache=jc, pos_offset=lo,
                                      mlora_idx=jnp.asarray(idx, jnp.int32))
                got, tc = tt.forward(tml, torch.from_numpy(toks[:, lo:hi]),
                                     tcfg, cache=tc, pos_offset=lo,
                                     mlora_idx=torch.from_numpy(idx))
                _close_rel(got, want)
            _close_rel(tc["k"], jc["k"])
            return
        if branch.startswith("ragged"):
            S = 3 if "s3" in branch else 1
            B, M = 4, 16
            rows = {k: rng.normal(size=(L, B, M, Hkv, Dh)).astype(np.float32)
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
            toks = rng.integers(0, jcfg.vocab_size, (B, S))
            idx = IDX[:B]
            want, jc = jt.forward(jml, jnp.asarray(toks), jcfg, cache=jc,
                                  pos_offset=jnp.asarray(pos),
                                  mlora_idx=jnp.asarray(idx, jnp.int32))
            got, tc = tt.forward(tml, torch.from_numpy(toks), tcfg, cache=tc,
                                 pos_offset=torch.from_numpy(pos),
                                 mlora_idx=torch.from_numpy(idx))
            _close_rel(got, want)
            if int8:
                _close_int8(tc["k"], jc["k"], tc["k_scale"], jc["k_scale"])
            else:
                _close_rel(tc["k"], jc["k"])
            return
        S = 3 if "s3" in branch else 1
        nb, bs = 16, 4
        shape = (L, nb, bs, Hkv, Dh)
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
        toks = rng.integers(0, jcfg.vocab_size, (6, S))
        pos = _POS if S == 3 else np.array([6, 9, 5, 19, 2, 3], np.int32)
        want, jc = jt.forward(jml, jnp.asarray(toks), jcfg, cache=jc,
                              pos_offset=jnp.asarray(pos),
                              mlora_idx=jnp.asarray(IDX, jnp.int32))
        got, tc = tt.forward(tml, torch.from_numpy(toks), tcfg, cache=tc,
                             pos_offset=torch.from_numpy(pos),
                             mlora_idx=torch.from_numpy(IDX))
        valid = _VALID[:, :S]
        _close_rel(got.numpy()[valid], np.asarray(want)[valid])
        if int8:
            hkv = jcfg.n_kv_heads
            _close_int8(tc["pool_k"][:, :-1], jc["pool_k"][:, :-1],
                        tc["pool_k_scale"][:, :-1],
                        np.asarray(jc["pool_k_scale"])[:, :-1, :hkv])
        else:
            _close_rel(tc["pool_k"][:, :-1], jc["pool_k"][:, :-1])


def _slot_scenario(srv, prompts, wrap, paged):
    """Adapters 0, 1, base; rounds of ticks; a chunked admission under
    adapter 2 (serial chunks, then fused ticks); an evict and the same
    prompt re-admitted under another adapter; a re-admit under the same
    one (a prefix hit on the paged server)."""
    log = []

    def steps(n):
        for _ in range(n):
            log.append(("step", sorted(srv.step().items())))

    def admit(key, adapter):
        slot = srv.admit(wrap(prompts[key]), adapter=adapter)
        log.append(("admit", key, adapter, slot,
                    srv.last_cached_len if paged else None))
        return slot

    admit("a", 0)
    admit("b", 1)
    admit("c", -1)
    steps(3)
    slot = srv.admit_start(wrap(prompts["d"]), adapter=2, chunk_tokens=4)
    log.append(("serial", srv.admit_step(slot)))
    while slot in srv._admissions:
        log.append(("fused", sorted(srv.step(prefill_work=slot).items())))
    steps(2)
    srv.evict(0)
    admit("a", 1)                      # same tokens, another adapter
    steps(2)
    srv.evict(1)
    admit("b", 1)                      # same adapter: a prefix hit
    steps(3)
    return log


def _prompts(vocab, seed=11):
    rng = np.random.default_rng(seed)
    return {"a": rng.integers(0, vocab, 13), "b": rng.integers(0, vocab, 9),
            "c": rng.integers(0, vocab, 6), "d": rng.integers(0, vocab, 11)}


SLOT_SERVERS = ["rows", "paged", "paged-spec", "paged-kvq"]


@pytest.fixture(scope="module", params=SLOT_SERVERS)
def lora_logs(request):
    kind = request.param
    jcfg = jt.tiny(remat=False)
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
    jp = dict(jp, layers={k: v * 4.0 if v.ndim == 3 else v
                          for k, v in jp["layers"].items()})
    tcfg, tp = bridge.config_from_jax(jcfg), bridge.params_from_jax(
        jp, device="cpu")
    _, jbank, tbank = _bank(jcfg, 3, seed=20)
    if kind == "rows":
        jsrv = jserving.SlotServer(jp, jcfg, n_slots=4, max_len=48,
                                   multi_lora=jbank)
        tsrv = tserving.SlotServer(tp, tcfg, n_slots=4, max_len=48,
                                   multi_lora=tbank, device="cpu")
    else:
        kw = dict(n_slots=4, n_blocks=64, block_size=4, prefix_cache=True,
                  kv_quant=kind == "paged-kvq")
        jkw, tkw = dict(kw), dict(kw)
        if kind == "paged-spec":
            jkw.update(speculative_draft=(jq.quantize_params(jp, jcfg), jcfg),
                       draft_layers_hook=jq.dequant_hook(jcfg), gamma=2)
            tkw.update(speculative_draft=(tq.quantize_params(tp, tcfg), tcfg),
                       draft_layers_hook=tq.dequant_hook(tcfg), gamma=2)
        jsrv = _unaliased(jpaged.PagedSlotServer(jp, jcfg, multi_lora=jbank,
                                                 **jkw))
        tsrv = tpaged.PagedSlotServer(tp, tcfg, multi_lora=tbank,
                                      device="cpu", **tkw)
    prompts = _prompts(jcfg.vocab_size)
    paged = kind != "rows"
    jlog = _slot_scenario(jsrv, prompts, lambda p: jnp.asarray(p, jnp.int32),
                          paged)
    tlog = _slot_scenario(tsrv, prompts, lambda p: p, paged)
    return kind, jlog, tlog, jsrv, tsrv


class TestServersWithABank:
    def test_streams_equal_jax(self, lora_logs):
        kind, jlog, tlog, _, _ = lora_logs
        assert [e[0] for e in tlog].count("fused") >= 1
        assert tlog == jlog
        if kind != "rows":
            hits = {(e[1], e[2]): e[4] for e in tlog if e[0] == "admit"}
            # Chains are salted by adapter: a's second admission under
            # another adapter reuses nothing; b under its own adapter
            # reuses its full blocks.
            assert hits[("a", 1)] == 0 and hits[("b", 1)] == 8

    def test_adapters_move_the_streams(self, lora_logs):
        """The same prompt under two adapters gives two streams (the
        bank's B is non-zero), so equal streams above are a check."""
        _, _, tlog, _, _ = lora_logs
        admits = [e for e in tlog if e[0] == "admit"]
        assert len({e[2] for e in admits}) == 3

    def test_fetches_and_slot_adapters(self, lora_logs):
        kind, _, _, jsrv, tsrv = lora_logs
        assert tsrv.device_fetches == jsrv.device_fetches
        np.testing.assert_array_equal(tsrv._ml._host,
                                      np.asarray(jsrv._ml._host))
        np.testing.assert_array_equal(tsrv._ml.dev.numpy(), tsrv._ml._host)
        if kind == "paged-spec":
            assert tsrv.spec_rounds == jsrv.spec_rounds > 0
            assert tsrv.spec_accepted_tokens == jsrv.spec_accepted_tokens


class TestBankValidation:
    @pytest.mark.parametrize("server", ["rows", "paged"])
    def test_out_of_range_and_bool_refused(self, server):
        _, _, tcfg, tp = _base()
        _, _, tbank = _bank(jt.tiny(remat=False), 2)
        srv = (tserving.SlotServer(tp, tcfg, n_slots=2, max_len=32,
                                   multi_lora=tbank, device="cpu")
               if server == "rows" else
               tpaged.PagedSlotServer(tp, tcfg, n_slots=2, n_blocks=16,
                                      multi_lora=tbank, device="cpu"))
        for bad, words in ((2, "out of range"), (-2, "out of range"),
                           (True, "must be an int")):
            with pytest.raises(ValueError, match=words):
                srv.admit(np.arange(5), adapter=bad)
        slot = srv.admit(np.arange(5), adapter=1)
        assert srv._ml._host[slot] == 1
        srv.evict(slot)
        assert srv._ml._host[slot] == -1

    def test_validate_adapter_matches_jax(self):
        for args in ((0, True, 2), (1, True, 2), (2, True, 2), (-1, False, 0),
                     (0, False, 0), (True, True, 2), ("1", True, 2)):
            got = want = None
            try:
                tserving.validate_adapter(*args)
            except ValueError as e:
                got = str(e)
            try:
                jserving.validate_adapter(*args)
            except ValueError as e:
                want = str(e)
            assert got == want, args

    def test_one_fetch_per_tick_with_a_bank(self):
        _, _, tcfg, tp = _base()
        _, _, tbank = _bank(jt.tiny(remat=False), 2)
        srv = tpaged.PagedSlotServer(tp, tcfg, n_slots=3, n_blocks=32,
                                     block_size=4, multi_lora=tbank,
                                     device="cpu")
        srv.admit(np.arange(6), adapter=1)
        slot = srv.admit_start(np.arange(20, 31), adapter=0, chunk_tokens=4)
        counts = []
        with count_fetches(counts):
            for _ in range(2):
                counts.append(0)
                srv.step()
            while slot in srv._admissions:
                counts.append(0)
                srv.step(prefill_work=slot)
        assert counts == [1] * len(counts), counts

    def test_speculation_needs_the_targets_geometry(self):
        _, _, tcfg, tp = _base()
        _, _, tbank = _bank(jt.tiny(remat=False), 2)
        dcfg = tt.tiny(n_layers=1)
        with pytest.raises(NotImplementedError, match="layer geometry"):
            tpaged.PagedSlotServer(
                tp, tcfg, n_slots=2, n_blocks=16, multi_lora=tbank,
                speculative_draft=(tt.init_params(0, dcfg, device="cpu"),
                                   dcfg), device="cpu")


class TestEngineAdapterField:
    def test_http_adapter_field_vs_jax(self):
        """POST /v1/completions with "adapter": an int bank index (-1
        the base model) serves, true/false and an index outside the bank
        are 400s, on both engines alike; the adapters' streams equal."""
        _, jbank, tbank = _bank(JCFG, 2, seed=30)
        answers = {}
        for which, mod, bank in (("jax", jserve, jbank),
                                 ("torch", tserve, tbank)):
            eng = _engine(which, multi_lora=bank, overlap_tick=False)
            httpd = mod.serve(eng, host="127.0.0.1", port=0,
                              timeout_s=HTTP_TIMEOUT)
            port = httpd.server_address[1]
            try:
                got = []
                for adapter in (0, 1, -1, True, False, 2, -3, "0"):
                    st, body = _post(port, {"prompt": [3, 1, 4, 1, 5],
                                            "max_tokens": 6,
                                            "adapter": adapter})
                    got.append((adapter, st, body.get("tokens")))
                answers[which] = got
            finally:
                _shutdown(httpd, eng)
        assert answers["torch"] == answers["jax"]
        statuses = {a: st for a, st, _ in answers["torch"]}
        assert statuses == {0: 200, 1: 200, -1: 200, True: 400, False: 400,
                            2: 400, -3: 400, "0": 400}
        toks = [t for _, st, t in answers["torch"] if st == 200]
        assert toks[0] != toks[2] or toks[1] != toks[2]

    def test_build_engine_takes_the_bank(self):
        """build_engine(args, multi_lora=bank): the CLI's engine (it has
        no adapter flag) serves every adapter as the engine built
        directly over the same weights and bank does, and the adapters
        move its streams."""
        _, _, tbank = _bank(JCFG, 2, seed=33)
        argv = ["--preset", "tiny", "--device", "cpu", "--n-slots", "3",
                "--n-blocks", "48", "--block-size", "4", "--seed", "0"]
        built = tserve.build_engine(
            tserve.build_parser().parse_args(argv), multi_lora=tbank)
        cfg = tt.tiny()
        direct = tserve.ServeEngine(
            tt.init_params(0, cfg, device="cpu"), cfg, n_slots=3,
            n_blocks=48, block_size=4, seed=0, device="cpu",
            multi_lora=tbank)
        streams = []
        for eng in (built, direct):
            reqs = _drive(eng, [_request(tserve, [3, 1, 4, 1, 5], 6,
                                         adapter=a) for a in (0, 1, -1)])
            assert all(r.error is None for r in reqs)
            streams.append([r.tokens for r in reqs])
            eng.stop()
        assert streams[0] == streams[1]
        assert streams[0][2] != streams[0][0] or \
            streams[0][2] != streams[0][1]

    def test_tick_driven_streams_equal_jax(self):
        """Tick-driven, one request per adapter plus a base one, batched:
        the port's streams equal the JAX engine's serial tick."""
        _, jbank, tbank = _bank(JCFG, 3, seed=31)
        rng = np.random.default_rng(32)
        prompts = [[int(t) for t in rng.integers(0, JCFG.vocab_size, n)]
                   for n in (6, 11, 9, 7)]
        adapters = [0, 2, -1, 1]
        streams = {}
        for which, mod, bank in (("jax", jserve, jbank),
                                 ("torch", tserve, tbank)):
            eng = _engine(which, multi_lora=bank, n_slots=4)
            reqs = _drive(eng, [_request(mod, p, 6, adapter=a)
                                for p, a in zip(prompts, adapters)])
            streams[which] = [r.tokens for r in reqs]
            assert all(r.error is None for r in reqs)
            eng.stop()
        assert streams["torch"] == streams["jax"]
