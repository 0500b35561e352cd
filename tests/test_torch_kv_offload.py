"""The port's host KV tier and cross-replica migration
(tpushare_torch.models.kvtier, the tier hooks of models/paged.py, the
engine's --host-kv-bytes, /kv/blocks and /kv/migrate) against the JAX
package's, on the CPU, scenario by scenario after tests/test_kv_offload.py.

- ``CrossoverEstimator`` and ``HostKvTier``: the same seeded op sequences
  (hypothesis) give the same decisions, evictions, refunds and
  snapshots in both packages (numpy payloads there, host tensors here).
- Demote -> promote roundtrips (dense, paged MoE, int8-self speculative,
  kv_quant) give EQUAL greedy streams to a never-evicted port server and
  to the JAX server (handed a fresh ``active`` array each call, ROADMAP
  C); chaos faults on demote and promote degrade to recompute,
  token-exact.
- The engine: the ``/stats`` host_tier keys and nulls equal the JAX
  engine's; gossip carries tier-resident chains; ``/kv/blocks`` omits
  unknown keys and its payloads decode to the JAX engine's within the
  f32 parity tolerance; a migration over HTTP is token-exact and stale
  gossip gives a clean miss.
- The wire between the packages, f32 and bf16 pools: a port engine lands
  a JAX engine's ``/kv/blocks`` and the other way round, bit-identical
  bytes, and both serve the prompt's stream.
- A prefetch stage makes no device-to-host fetch (the one-fetch spy).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tpushare.cli import serve as jserve
from tpushare.models import kvtier as jkv
from tpushare.models import paged as jpaged
from tpushare.models import transformer as jt
from tpushare.slo import quota as jquota

from tpushare_torch.cli import serve as tserve
from tpushare_torch.models import bridge
from tpushare_torch.models import kvtier as tkv
from tpushare_torch.models import paged as tpaged
from tpushare_torch.slo import quota as tquota
from tests.test_torch_paged import _pair, _unaliased, count_fetches
from tests.test_torch_serve import (HTTP_TIMEOUT, KW, _drive, _get, _post,
                                    _shutdown)

BS = 4
SETTINGS = settings(max_examples=40, deadline=None, derandomize=True,
                    suppress_health_check=[HealthCheck.too_slow])
JCFG, JP, TCFG, TP = _pair("tiny")
TENANTS = ["acme", "bg", None]


# ---------------------------------------------------------------------
# CrossoverEstimator and HostKvTier: the same op sequences, both packages
# ---------------------------------------------------------------------

def _block(pkg, rows, fill):
    """One fake block payload of ``rows`` x 256 B per leaf."""
    if pkg == "jax":
        return {"pool_k": np.full((rows, 4, 2, 8), fill, np.float32),
                "pool_v": np.full((rows, 4, 2, 8), -fill, np.float32)}
    return {"pool_k": torch.full((rows, 4, 2, 8), fill, dtype=torch.float32),
            "pool_v": torch.full((rows, 4, 2, 8), -fill,
                                 dtype=torch.float32)}


def _as_np(data):
    if data is None:
        return None
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in data.items()}


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


_tier_ops = st.lists(st.tuples(
    st.sampled_from(["put", "migrate", "pop", "get", "has", "promote",
                     "take", "stage", "clear", "xfer", "prefill",
                     "decide", "fault", "tokens"]),
    st.integers(0, 6), st.sampled_from(TENANTS), st.integers(1, 3),
    st.integers(0, 9)), min_size=1, max_size=50)


@SETTINGS
@given(_tier_ops)
def test_tier_same_decisions_evictions_refunds_and_snapshots(ops):
    spec = "acme=0::2048,bg=0::"
    tiers = {}
    for pkg, kv, qmod in (("jax", jkv, jquota), ("torch", tkv, tquota)):
        q = qmod.KvQuota(qmod.parse_quota_spec(spec))
        tiers[pkg] = (kv.HostKvTier(3000, quota=q), q)
    for op, ki, tenant, rows, n in ops:
        key = b"k%d" % ki
        outs = {}
        for pkg, (tier, q) in tiers.items():
            est = tier.estimator
            out = None
            if op in ("put", "migrate"):
                out = tier.put(key, _block(pkg, rows, float(n)),
                               tenant=tenant, tokens=n,
                               kind="migrate" if op == "migrate"
                               else "demote")
            elif op == "pop":
                out = _as_np(tier.pop(key))
            elif op == "get":
                out = _as_np(tier.get(key))
            elif op == "has":
                out = tier.has(key)
            elif op == "promote":
                out = tier.begin_promote(key, tokens=n)
            elif op == "take":
                data, staged = tier.take_promote(key)
                out = (staged, data if staged else _as_np(data))
            elif op == "stage":
                tier.stage(key, {"pool_k": n})
            elif op == "clear":
                tier.clear_staged(keep=[b"k%d" % i for i in range(n % 4)])
            elif op == "xfer":
                est.observe_transfer(jkv.CHANNELS[n % 3], rows * 100 * n,
                                     0.5 * (ki % 3))
            elif op == "prefill":
                est.observe_prefill(n, 0.25 * (ki % 3))
            elif op == "decide":
                out = est.decide(jkv.CHANNELS[ki % 3], rows * 250, n)
            elif op == "fault":
                def boom():
                    raise RuntimeError("injected")
                tier.fault_promote = boom if n % 2 else None
            else:
                out = tier.entry_tokens(key)
            outs[pkg] = (out, tier.snapshot(), q.snapshot(),
                         tier.keys_hex(), est.rate("h2d"),
                         est.prefill_rate())
        j, t = outs["jax"], outs["torch"]
        if op in ("pop", "get"):
            assert _same(j[0], t[0])
        elif op == "take":
            assert j[0][0] == t[0][0] and (
                j[0][1] == t[0][1] if j[0][0] else _same(j[0][1], t[0][1]))
        else:
            assert j[0] == t[0]
        assert j[1:] == t[1:]


class TestEstimatorAndTier:
    """tests/test_kv_offload.py's unit scenarios, held to the JAX
    package's answers."""

    @pytest.mark.parametrize("case", ["unmeasured", "measured", "channels",
                                      "garbage"])
    def test_estimator(self, case):
        snaps = []
        for kv in (jkv, tkv):
            est = kv.CrossoverEstimator()
            out = []
            if case == "unmeasured":
                out.append(est.decide("h2d", 1 << 20, 64))
            elif case == "measured":
                est.observe_transfer("h2d", 1000, 1.0)
                est.observe_prefill(100, 1.0)
                out += [est.decide("h2d", 500, 100),
                        est.decide("h2d", 10_000, 100),
                        est.decide("h2d", 1000, 100)]
            elif case == "channels":
                est.observe_prefill(100, 1.0)
                est.observe_transfer("net", 10, 1.0)
                est.observe_transfer("h2d", 1_000_000, 1.0)
                out += [est.decide(c, 1000, 100) for c in jkv.CHANNELS]
            else:
                est.observe_transfer("h2d", 0, 1.0)
                est.observe_transfer("h2d", 100, 0.0)
                est.observe_transfer("bogus", 100, 1.0)
                est.observe_prefill(0, 1.0)
                out += [est.rate("h2d"), est.prefill_rate()]
            snaps.append((out, est.snapshot()))
        assert snaps[0] == snaps[1]
        assert tkv.CHANNELS == jkv.CHANNELS

    def test_budget_lru_oversize_and_refunds(self):
        nb = 2 * 256
        for kv, pkg in ((jkv, "jax"), (tkv, "torch")):
            with pytest.raises(ValueError):
                kv.HostKvTier(0)
        snaps = []
        for kv, pkg in ((jkv, "jax"), (tkv, "torch")):
            q = (jquota if pkg == "jax" else tquota).KvQuota()
            tier = kv.HostKvTier(2 * nb, quota=q)
            data = _block(pkg, 1, 3.0)
            assert tier.put(b"k0", data, tenant="t", tokens=BS)
            assert tier.get(b"k0") is data
            for i in range(1, 3):
                tier.put(b"k%d" % i, _block(pkg, 1, float(i)), tenant="t")
            assert not tier.put(b"big", _block(pkg, 3, 0.0))
            taken, staged = tier.take_promote(b"k2")
            assert not staged and tier.has(b"k2")       # inclusive
            tier.pop(b"k1")
            snaps.append((tier.snapshot(), dict(q.host_used)))
        assert snaps[0] == snaps[1]
        assert snaps[1][0]["evictions"] == 1
        assert snaps[1][0]["put_refused"] == 1

    def test_tenant_spill_isolation(self):
        got = []
        for kv, qm, pkg in ((jkv, jquota, "jax"), (tkv, tquota, "torch")):
            quota = qm.KvQuota(qm.parse_quota_spec("acme=0::%d" % 1024))
            tier = kv.HostKvTier(100 * 512, quota=quota)
            tier.put(b"bg", _block(pkg, 1, 0.0), tenant="internal")
            for i in range(4):
                tier.put(b"a%d" % i, _block(pkg, 1, float(i)),
                         tenant="acme")
            got.append((tier.keys_hex(), quota.snapshot()))
        assert got[0] == got[1]
        assert got[1][0] == [b"bg".hex(), b"a2".hex(), b"a3".hex()]

    def test_timed_feeds_a_completed_span(self):
        outs = [kv.timed(lambda: 7) for kv in (jkv, tkv)]
        assert [o[0] for o in outs] == [7, 7]
        assert all(o[1] >= 0 for o in outs)

    def test_copy_out_is_private(self):
        tier = tkv.HostKvTier(1 << 20)
        data = _block("torch", 1, 2.0)
        tier.put(b"k", data)
        out = tier.copy_out(b"k")
        out["pool_k"].fill_(9.0)
        assert float(data["pool_k"][0, 0, 0, 0]) == 2.0
        assert tier.copy_out(b"missing") is None


# ---------------------------------------------------------------------
# Demote -> promote roundtrips, token-exact
# ---------------------------------------------------------------------

def _prompt(seed, n, vocab=None):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab or JCFG.vocab_size, n).astype(np.int32)


def _decode(srv, slot, n):
    """Flattened greedy stream (speculative servers return bursts)."""
    out = [int(srv.last_token[slot, 0])]
    while len(out) < n:
        tok = srv.step()[slot]
        out.extend(tok if isinstance(tok, list) else [tok])
    return out[:n]


def _force_transfer(tier):
    """Pin the crossover policy to transfer: these tests hold the
    mechanism; whether the measured policy would bother is timing."""
    tier.estimator.observe_transfer("d2h", 1 << 40, 1.0)
    tier.estimator.observe_transfer("h2d", 1 << 40, 1.0)
    return tier


def _roundtrip(make, tier, n_decode=6, vocab=None):
    """Warm prompt A, evict, thrash the pool with fillers until A's
    blocks demote, re-admit A. Returns (never-evicted port tokens, tier
    tokens, the server)."""
    a = _prompt(1, 13, vocab)
    big = make(None, 64)
    want = _decode(big, big.admit(a), n_decode)
    srv = make(tier, 10)
    slot = srv.admit(a)
    _decode(srv, slot, n_decode)
    srv.evict(slot)
    for seed in range(3, 7):
        srv.evict(srv.admit(_prompt(seed, 13, vocab)))
    return want, _decode(srv, srv.admit(a), n_decode), srv


def _dense_maker(params=TP, cfg=TCFG, **kw):
    def make(tier, nb):
        return tpaged.PagedSlotServer(
            params, cfg, n_slots=2, n_blocks=nb, block_size=BS,
            max_blocks_per_slot=8, prefix_cache=True, device="cpu",
            host_tier=tier, **kw)
    return make


def _jax_stream(n_decode=6, params=JP, cfg=JCFG, vocab=None, **kw):
    jsrv = _unaliased(jpaged.PagedSlotServer(
        params, cfg, n_slots=2, n_blocks=64, block_size=BS,
        max_blocks_per_slot=8, prefix_cache=True, **kw))
    slot = jsrv.admit(jnp.asarray(_prompt(1, 13, vocab)))
    return _decode(jsrv, slot, n_decode)


class TestRoundtrip:
    def test_dense(self):
        tier = _force_transfer(tkv.HostKvTier(32 << 20))
        want, got, srv = _roundtrip(_dense_maker(), tier)
        assert got == want == _jax_stream()
        snap = tier.snapshot()
        assert snap["demotions"] > 0 and snap["promotions"] > 0
        assert srv.last_cached_len > 0
        cx = snap["crossover"]
        assert cx["channels"]["d2h"]["transfers"] > 1
        assert cx["channels"]["h2d"]["transfers"] > 1
        # One arena, allocated once at attach: every payload a slot.
        assert tier.arena.n_slots >= (32 << 20) // tier.arena.block_bytes

    def test_kv_quant(self):
        """int8 pools demote all four leaves (k, v and both scale
        pages); a missing scale page would dequantize garbage."""
        tier = _force_transfer(tkv.HostKvTier(32 << 20))
        want, got, _ = _roundtrip(_dense_maker(kv_quant=True), tier)
        assert got == want == _jax_stream(kv_quant=True)
        assert tier.snapshot()["promotions"] > 0
        assert {f for f, _, _ in tier.arena.layout} == {
            "pool_k", "pool_v", "pool_k_scale", "pool_v_scale"}

    def test_speculative(self):
        """Promotion restores TARGET KV only; greedy speculation stays
        target-law whatever the draft's KV holds."""
        jd = jt.init_params(jax.random.PRNGKey(9), JCFG)
        tdraft = (bridge.params_from_jax(jd, device="cpu"), TCFG)
        tier = _force_transfer(tkv.HostKvTier(32 << 20))
        want, got, _ = _roundtrip(
            _dense_maker(speculative_draft=tdraft, gamma=2), tier)
        assert got == want == _jax_stream(speculative_draft=(jd, JCFG),
                                          gamma=2)
        assert tier.snapshot()["promotions"] > 0

    def test_paged_moe(self):
        from tests.test_torch_moe import _pair as moe_pair
        from tpushare.models import moe as jm
        from tpushare_torch.models import moe as tm
        jcfg, jp, tcfg, tp = moe_pair()
        tier = _force_transfer(tkv.HostKvTier(32 << 20))
        want, got, _ = _roundtrip(
            _dense_maker(tp, tcfg, forward_fn=tm.paged_forward), tier,
            vocab=jcfg.vocab_size)
        assert got == want == _jax_stream(params=jp, cfg=jcfg,
                                          vocab=jcfg.vocab_size,
                                          forward_fn=jm.paged_forward)
        assert tier.snapshot()["promotions"] > 0

    def test_failed_promotion_recomputes(self):
        tier = _force_transfer(tkv.HostKvTier(32 << 20))

        def boom():
            raise RuntimeError("injected promote fault")
        tier.fault_promote = boom
        want, got, _ = _roundtrip(_dense_maker(), tier)
        assert got == want
        snap = tier.snapshot()
        assert snap["promotions"] == 0 and snap["promote_failures"] > 0

    def test_failed_demotion_degrades_to_eviction(self):
        tier = _force_transfer(tkv.HostKvTier(32 << 20))

        def boom():
            raise RuntimeError("injected demote fault")
        tier.fault_demote = boom
        want, got, _ = _roundtrip(_dense_maker(), tier)
        assert got == want
        snap = tier.snapshot()
        assert snap["demotions"] == 0 and snap["demote_failures"] > 0
        assert tier.arena.free_slots == tier.arena.n_slots

    def test_recompute_policy_skips_demotion(self):
        tier = tkv.HostKvTier(32 << 20)
        tier.estimator.observe_transfer("d2h", 1, 10.0)
        tier.estimator.observe_prefill(10_000, 0.001)
        want, got, _ = _roundtrip(_dense_maker(), tier)
        assert got == want
        snap = tier.snapshot()
        assert snap["demotions"] == 0
        assert snap["crossover"]["decisions"]["recompute"] > 0

    def test_small_tier_evicts_and_returns_slots(self):
        """A tier that holds four blocks: the thrash evicts, every
        evicted entry's arena slot returns, streams stay exact."""
        layout_bytes = 2 * 2 * BS * 2 * 32 * 4      # L, bs, Hkv, Dh, f32
        tier = _force_transfer(tkv.HostKvTier(4 * layout_bytes))
        want, got, _ = _roundtrip(_dense_maker(), tier)
        assert got == want
        snap = tier.snapshot()
        assert snap["evictions"] > 0 and snap["blocks_resident"] <= 4
        assert tier.arena.n_slots - tier.arena.free_slots \
            == snap["blocks_resident"]

    def test_prefetch_makes_no_fetch_and_hits(self):
        tier = _force_transfer(tkv.HostKvTier(32 << 20))
        make = _dense_maker()
        a = _prompt(1, 13)
        big = make(None, 64)
        want = _decode(big, big.admit(a), 6)
        srv = make(tier, 10)
        srv.evict(srv.admit(a))
        for seed in range(3, 7):
            srv.evict(srv.admit(_prompt(seed, 13)))
        counts = [0]
        with count_fetches(counts):
            staged = srv.prefetch_prefix(a)
        assert counts == [0] and staged > 0 and len(tier.staged) == staged
        hits0 = tier.prefetch_hits
        slot = srv.admit(a)
        assert tier.prefetch_hits - hits0 == staged
        assert _decode(srv, slot, 6) == want

    def test_quota_spill_charged_to_first_writer(self):
        quota = tquota.KvQuota(tquota.parse_quota_spec(
            "acme=0::%d" % (64 << 20)))
        tier = _force_transfer(tkv.HostKvTier(64 << 20, quota=quota))
        srv = _dense_maker(kv_quota=quota)(tier, 10)
        srv.evict(srv.admit(_prompt(1, 13), tenant="acme"))
        for seed in range(3, 7):
            srv.evict(srv.admit(_prompt(seed, 13), tenant="acme"))
        assert tier.snapshot()["demotions"] > 0
        row = quota.snapshot()["acme"]
        assert row["host_bytes_used"] > 0
        assert row["host_bytes"] == 64 << 20


# ---------------------------------------------------------------------
# The engine and its HTTP surface
# ---------------------------------------------------------------------

def _engine(which, **kw):
    opts = dict(KW, **kw)
    if which == "jax":
        opts.setdefault("overlap_tick", False)
        return jserve.ServeEngine(JP, JCFG, **opts)
    return tserve.ServeEngine(TP, TCFG, device="cpu", **opts)


def _served(which, **kw):
    eng = _engine(which, **kw)
    mod = jserve if which == "jax" else tserve
    httpd = mod.serve(eng, host="127.0.0.1", port=0,
                      timeout_s=HTTP_TIMEOUT)
    return eng, httpd, httpd.server_address[1]


def _complete(port, prompt, n=4):
    st_, body = _post(port, {"prompt": [int(t) for t in prompt],
                             "max_tokens": n})
    assert st_ == 200, body
    return body["tokens"]


def _shape(obj):
    """Keys and nulls of a JSON tree (values dropped)."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    return obj is None


class TestEngine:
    def test_stats_keys_and_nulls_match_the_jax_engine(self):
        shapes = {}
        for which in ("jax", "torch"):
            for tier in (0, 8 << 20):
                eng, httpd, port = _served(which, host_kv_bytes=tier)
                try:
                    _complete(port, _prompt(2, 11))
                    st_ = json.loads(_get(port, "/stats")[1])
                    shapes[which, tier] = (_shape(st_["host_tier"]),
                                           st_["host_prefetch_errors"])
                finally:
                    _shutdown(httpd, eng)
        assert shapes["torch", 0] == shapes["jax", 0] == (True, None)
        assert shapes["torch", 8 << 20] == shapes["jax", 8 << 20]
        assert shapes["torch", 8 << 20][1] == 0

    @pytest.mark.parametrize("kw,match", [
        ({"prefix_cache": False}, "prefix_cache"),
        ({"model_family": "moe", "kv": "rows"}, "paged KV pool"),
    ])
    def test_preconditions_raise_as_the_reference(self, kw, match):
        errs = []
        for which in ("jax", "torch"):
            opts = dict(kw, host_kv_bytes=1 << 20)
            if "model_family" in kw:
                from tpushare.models import moe as jm
                from tpushare_torch.models import moe as tm
                jcfg = jm.tiny(remat=False)
                jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
                base = dict(n_slots=2, max_len=64, chaos_spec="")
                with pytest.raises(ValueError) as ei:
                    if which == "jax":
                        jserve.ServeEngine(jp, jcfg, **base, **opts)
                    else:
                        tcfg = bridge.moe_config_from_jax(jcfg)
                        tserve.ServeEngine(
                            bridge.params_from_jax(jp, device="cpu"),
                            tcfg, device="cpu", **base, **opts)
            else:
                with pytest.raises(ValueError) as ei:
                    _engine(which, **opts)
            errs.append(str(ei.value))
        assert errs[0] == errs[1] and match in errs[1]

    def test_flag_builds_a_tier_and_requires_the_prefix_cache(self):
        args = tserve.build_parser().parse_args(
            ["--device", "cpu", "--host-kv-bytes", "1048576"])
        eng = tserve.build_engine(args)
        assert eng._host_tier.budget_bytes == 1 << 20
        assert eng.srv.cache.host_tier is eng._host_tier
        args = tserve.build_parser().parse_args(
            ["--device", "cpu", "--host-kv-bytes", "1048576",
             "--no-prefix-cache"])
        with pytest.raises(ValueError, match="prefix_cache"):
            tserve.build_engine(args)

    def test_gossip_includes_tier_resident_chains(self):
        eng, httpd, port = _served("torch", host_kv_bytes=8 << 20)
        try:
            _complete(port, _prompt(0, 20))
            dev_keys = set(eng.prefix_keys()["keys"])
            eng._host_tier.put(b"\x01" * 32, _block("torch", 1, 0.0))
            keys = json.loads(_get(port, "/prefixes")[1])["keys"]
            assert "01" * 32 in keys and dev_keys <= set(keys)
        finally:
            _shutdown(httpd, eng)

    def test_kv_blocks_omits_unknown_and_decodes_to_the_jax_engine(self):
        prompt = _prompt(1, 20)
        got = {}
        for which in ("jax", "torch"):
            eng, httpd, port = _served(which, host_kv_bytes=8 << 20)
            try:
                _complete(port, prompt)
                keys = eng.prefix_keys()["keys"]
                assert len(keys) == 20 // BS
                q = ",".join(keys + ["ff" * 32, "zz-not-hex"])
                st_, body = _get(port, "/kv/blocks?keys=" + q)
                assert st_ == 200
                got[which] = (keys, json.loads(body))
            finally:
                _shutdown(httpd, eng)
        (jkeys, jout), (tkeys, tout) = got["jax"], got["torch"]
        assert jkeys == tkeys
        assert tout["block_size"] == jout["block_size"] == BS
        assert set(tout["blocks"]) == set(jout["blocks"]) == set(tkeys)
        layout = [(f, tuple(r["shape"]), torch.float32)
                  for f, r in tout["blocks"][tkeys[0]].items()]
        for kh in tkeys:
            a = tserve._unwire_block(tout["blocks"][kh], layout)
            b = tserve._unwire_block(jout["blocks"][kh], layout)
            for f in a:
                np.testing.assert_allclose(a[f].numpy(), b[f].numpy(),
                                           atol=5e-5, rtol=5e-5)

    def test_migration_over_http_is_token_exact_and_stale_is_clean(self):
        a_eng, a_httpd, a_port = _served("torch", host_kv_bytes=8 << 20)
        b_eng, b_httpd, b_port = _served("torch", host_kv_bytes=8 << 20)
        try:
            prompt = _prompt(5, 20)
            want = _complete(a_port, prompt)
            keys = a_eng.prefix_keys()["keys"]
            a_url = "http://127.0.0.1:%d" % a_port
            st_, out = _post(b_port, {"source": a_url,
                                      "keys": [keys[0], "ee" * 32,
                                               keys[1]]},
                             path="/kv/migrate")
            assert st_ == 200 and out["migrated"] == 1
            st_, out = _post(b_port, {"source": a_url, "keys": keys,
                                      "tenant": "acme"},
                             path="/kv/migrate")
            assert out == {"migrated": len(keys), "decision": "transfer",
                           "requested": len(keys)}
            ht = b_eng._host_tier.snapshot()
            assert ht["migrations_in"] == len(keys) + 1
            assert ht["crossover"]["channels"]["net"]["bytes_per_s"] \
                is not None
            assert _complete(b_port, prompt) == want
            assert b_eng._host_tier.snapshot()["promotions"] > 0
            out = b_eng.kv_migrate("http://127.0.0.1:9", ["aa" * 32])
            assert out["migrated"] == 0 and "error" in out
            assert _post(b_port, {"source": a_url, "keys": "ab"},
                         path="/kv/migrate")[0] == 400
        finally:
            _shutdown(a_httpd, a_eng)
            _shutdown(b_httpd, b_eng)

    def test_overlap_window_prefetches_the_head_request(self):
        """The overlapped tick stages the queued head request's tier
        chain inside the flight window (no fetch: one per tick still),
        and its admission takes the staged blocks: a prefetch hit, the
        stream equal to an untiered engine's."""
        a, busy = _prompt(1, 13), _prompt(2, 9)
        fillers = [_prompt(s, 13) for s in range(3, 7)]
        streams = {}
        for tier in (0, 8 << 20):
            eng = _engine("torch", host_kv_bytes=tier, n_slots=1,
                          n_blocks=12, overlap_tick=True)
            if tier:
                _force_transfer(eng._host_tier)
            reqs = [tserve._Request(list(p), 4, None)
                    for p in [a] + fillers]
            _drive(eng, reqs)
            # One slot: A queues behind the busy request, so it is the
            # head while the busy request's ticks are in flight.
            last = [tserve._Request(list(busy), 6, None),
                    tserve._Request(list(a), 4, None)]
            _drive(eng, last)
            streams[tier] = [r.tokens for r in reqs + last]
            st_ = eng.stats()
            if tier:
                ht = st_["host_tier"]
                assert ht["prefetch_hit_rate"] and ht["prefetch_hit_rate"] > 0
                assert st_["host_prefetch_errors"] == 0
            assert st_["device_fetches"] <= st_["work_ticks"]
            eng.stop()
        assert streams[0] == streams[8 << 20]

    def test_engine_tier_storm_adds_no_fetch(self):
        """tests/test_sync_free.py's engine pin on the port: a storm that
        demotes at admission and promotes on re-admission, the prefetch
        hook live, keeps fetches_per_tick <= 1.0 and one forward per
        tick, and the spy over every ``_loop_once`` counts the same
        device-to-host reads tick by tick as an untiered engine's (the
        tier's copies and the prefetch add none). A's streams equal the
        JAX engine's."""
        prompts = [_prompt(1, 13)] + [_prompt(s, 13) for s in (3, 4, 5, 6)]
        prompts.append(prompts[0])
        runs = {}
        for tier_bytes in (0, 32 << 20):
            eng = _engine("torch", host_kv_bytes=tier_bytes, n_slots=2,
                          n_blocks=16)
            if tier_bytes:
                _force_transfer(eng._host_tier)
            per_tick, got = [], []
            for prompt in prompts:
                r = tserve._Request(list(prompt), 2, None)
                assert eng.submit(r)
                with eng._on_device():
                    for _ in range(3000):
                        if r.done.is_set():
                            break
                        per_tick.append(0)
                        with count_fetches(per_tick):
                            eng._loop_once()
                assert r.done.is_set() and r.error is None, r.error
                got.append(r.tokens)
            st_ = eng.stats()
            assert st_["fetches_per_tick"] <= 1.0
            assert st_["forwards_per_tick"] == 1.0
            runs[tier_bytes] = (per_tick, got, st_["host_tier"])
            eng.stop()
        ht = runs[32 << 20][2]
        assert ht["demotions"] > 0 and ht["promotions"] > 0
        assert runs[32 << 20][0] == runs[0][0]
        jeng = _engine("jax", n_slots=2, n_blocks=16)
        want = [r.tokens for r in _drive(jeng, [
            jserve._Request(list(p), 2, None) for p in prompts])]
        jeng.stop()
        assert runs[32 << 20][1] == runs[0][1] == want

    def test_engine_chaos_points_degrade_to_recompute(self):
        """kv.demote and kv.promote wired from --chaos-spec: every
        demotion fails, the streams stay exact."""
        prompts = [_prompt(s, 13) for s in (1, 3, 4, 5, 6, 1)]
        streams = {}
        for spec in ("", "demote:raise@p=1.0;promote:raise@p=1.0;seed=1"):
            eng, httpd, port = _served("torch", host_kv_bytes=8 << 20,
                                       n_blocks=12, chaos_spec=spec)
            try:
                streams[spec] = [_complete(port, p) for p in prompts]
                ht = eng.stats()["host_tier"]
            finally:
                _shutdown(httpd, eng)
            if spec:
                assert ht["demote_failures"] > 0 and ht["demotions"] == 0
            else:
                assert ht["demotions"] > 0 and ht["promotions"] > 0
        assert streams[""] == list(streams.values())[1]


# ---------------------------------------------------------------------
# The wire between the two packages
# ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("source", ["jax", "torch"])
def test_cross_package_wire(source, dtype):
    """One package's engine serves a prompt and its blocks; the other
    package's engine pulls them over /kv/migrate, holds bit-identical
    bytes (read back from its own /kv/blocks), promotes them and serves
    the same stream as the source."""
    jcfg = dataclasses.replace(JCFG, dtype=getattr(jnp, dtype))
    jp = jax.tree_util.tree_map(lambda x: x.astype(jcfg.dtype), JP)
    tcfg = bridge.config_from_jax(jcfg)
    tp = bridge.params_from_jax(jp, device="cpu")
    sink = "torch" if source == "jax" else "jax"
    engs = {}
    for which in (source, sink):
        opts = dict(KW, host_kv_bytes=8 << 20)
        if which == "jax":
            eng = jserve.ServeEngine(jp, jcfg, overlap_tick=False, **opts)
        else:
            eng = tserve.ServeEngine(tp, tcfg, device="cpu", **opts)
        mod = jserve if which == "jax" else tserve
        httpd = mod.serve(eng, host="127.0.0.1", port=0,
                          timeout_s=HTTP_TIMEOUT)
        engs[which] = (eng, httpd, httpd.server_address[1])
    try:
        prompt = _prompt(8, 21)
        want = _complete(engs[source][2], prompt, n=6)
        keys = engs[source][0].prefix_keys()["keys"]
        src_blocks = json.loads(_get(
            engs[source][2], "/kv/blocks?keys=" + ",".join(keys))[1])
        st_, out = _post(engs[sink][2], {
            "source": "http://127.0.0.1:%d" % engs[source][2],
            "keys": keys}, path="/kv/migrate")
        assert st_ == 200 and out["migrated"] == len(keys), out
        landed = json.loads(_get(
            engs[sink][2], "/kv/blocks?keys=" + ",".join(keys))[1])
        assert landed["blocks"] == src_blocks["blocks"]
        for rec in landed["blocks"].values():
            assert {leaf["dtype"] for leaf in rec.values()} == {dtype}
        assert _complete(engs[sink][2], prompt, n=6) == want
        assert engs[sink][0].stats()["host_tier"]["promotions"] > 0
    finally:
        for eng, httpd, _ in engs.values():
            _shutdown(httpd, eng)
