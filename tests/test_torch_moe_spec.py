"""The rest of the port's single-card MoE family against the JAX
package's, on the CPU: the dropless / expert_choice / a2a routings,
``phase_timer``, ``quant.quantized_forward``, and MoE speculation on
``MoESlotServer`` and on the paged server (``forward_fn=
moe.paged_forward``), through the engine too.

Weights come from JAX ``init_params`` trees bridged with
``bridge.params_from_jax`` (layer matrices x4 where greedy streams
should change every tick). Tolerances: f32 logits within 5e-5 of the
largest |logit| (the libraries sum in different orders, nothing else);
bf16, at the init scale, within 2e-2 of it (each framework rounds
activations to bf16 at its own points; readings ran 0.0076-0.0096. At
x4 weights such roundings flip top-k routes and the flips cascade,
0.02-0.26). Greedy streams, accepted-draft counts and fetch counts
must be EQUAL. The stochastic law of a round's first token is held to
the oracle's bound (TV below the null TV's mean + 4 sd).
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.cli import serve as jserve
from tpushare.models import moe as jm
from tpushare.models import paged as jpaged
from tpushare.models import quant as jq
from tpushare.models import transformer as jt
from tpushare.utils import profiling as jprof

from tpushare_torch.cli import serve as tserve
from tpushare_torch.models import bridge, paged
from tpushare_torch.models import moe as tm
from tpushare_torch.models import quant as tq
from tpushare_torch.models import transformer as tt
from tpushare_torch.utils import profiling as tprof
from tests.test_torch_moe import (_close_rel, _forward_case, _prompts,
                                  _scenario, _tokens)
from tests.test_torch_paged import _unaliased, count_fetches
from tests.test_torch_serve import _drive, _request

BF16_REL = 2e-2
ROUTINGS = ["a2a", "dropless", "expert_choice"]


def _pair(routing="psum", capacity_factor=None, dtype="f32", seed=0,
          scale=4.0):
    jcfg = jm.tiny(remat=False, routing=routing,
                   capacity_factor=capacity_factor)
    if dtype == "bf16":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    jp = jm.init_params(jax.random.PRNGKey(seed), jcfg)
    jp = dict(jp, layers={k: (v * scale).astype(v.dtype) if v.ndim >= 3
                          else v for k, v in jp["layers"].items()})
    return jcfg, jp, bridge.moe_config_from_jax(jcfg), \
        bridge.params_from_jax(jp, device="cpu")


def _close(got, want, dtype):
    if dtype == "f32":
        _close_rel(got, want)
        return
    got = np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=BF16_REL * np.abs(want).max())


class TestRoutingParity:
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    @pytest.mark.parametrize("capacity", [None, 1.5])
    @pytest.mark.parametrize("routing", ROUTINGS)
    def test_no_cache_vs_jax(self, routing, capacity, dtype):
        """Every routing, dense or capacity-bounded, f32 and bf16, with
        its aux loss (expert_choice's exactly 0)."""
        jcfg, jp, tcfg, tp = _pair(routing, capacity, dtype, seed=1,
                                   scale=4.0 if dtype == "f32" else 1.0)
        toks = _tokens(60, 2, 9)
        want, jaux = jm.forward(jp, jnp.asarray(toks), jcfg)
        got, taux = tm.forward(tp, torch.from_numpy(toks), tcfg)
        _close(got, want, dtype)
        assert abs(float(taux) - float(jaux)) < (1e-5 if dtype == "f32"
                                                 else 2e-2)
        if routing == "expert_choice":
            assert float(taux) == 0.0 == float(jaux)

    @pytest.mark.parametrize("branch", ["prefill_rows", "ragged_s1",
                                        "ragged_s3", "paged_s1",
                                        "paged_s3"])
    @pytest.mark.parametrize("routing", ROUTINGS)
    def test_cache_branches_vs_jax(self, routing, branch):
        jcfg, jp, tcfg, tp = _pair(routing, seed=2)
        # Expert choice couples a batch's rows (experts pick among all
        # of them), so an inactive row's junk reaches the real rows'
        # outputs. At paged S > 1 that junk reads an unallocated page,
        # which the kernel's plain version skips and the reference's
        # gathered view reads as the trash block: the port takes the
        # gathered view there.
        impl = ("reference" if (routing, branch) == ("expert_choice",
                                                     "paged_s3")
                else "auto")
        got, want, valid = _forward_case(branch, jcfg, jp, tcfg, tp, None,
                                         None, impl)
        if valid is not None:
            got, want = got.numpy()[valid], np.asarray(want)[valid]
        _close_rel(got, want)

    @pytest.mark.parametrize("routing", ["a2a", "expert_choice"])
    def test_int8_fused_experts_vs_jax(self, routing):
        """The queue-shaped routings run their expert products through
        the int8 kernel's path (its plain version here)."""
        jcfg, jp, tcfg, tp = _pair(routing, 1.5, seed=3)
        jqp, tqp = jq.quantize_params(jp, jcfg), tq.quantize_params(tp, tcfg)
        toks = _tokens(61, 2, 9)
        want, _ = jm.forward(jqp, jnp.asarray(toks), jcfg,
                             layers_hook=jq.fused_expert_hook(jcfg))
        seen = []
        orig = tm._q8_expert_mlps

        def spy(x_e, layer, cfg):
            seen.append(tuple(x_e.shape))
            return orig(x_e, layer, cfg)

        tm._q8_expert_mlps = spy
        try:
            got, _ = tm.forward(tqp, torch.from_numpy(toks), tcfg,
                                layers_hook=tq.fused_expert_hook(tcfg))
        finally:
            tm._q8_expert_mlps = orig
        _close_rel(got, want)
        assert len(seen) == tcfg.n_layers and all(len(s) == 3 for s in seen)


class TestDropless:
    def test_matches_dense_and_jax(self):
        """TestDroplessRouting's case: dropless equals the dense psum
        formulation (up to summation order), and the JAX dropless."""
        jcfg, jp, tcfg, tp = _pair("dropless", seed=4, scale=1.0)
        dense = bridge.moe_config_from_jax(jm.tiny(remat=False))
        toks = torch.from_numpy(_tokens(62, 2, 16))
        got, aux = tm.forward(tp, toks, tcfg)
        ref, aux_d = tm.forward(tp, toks, dense)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-4,
                                   atol=2e-4)
        assert abs(float(aux) - float(aux_d)) < 1e-6 * max(1, float(aux_d))
        want, _ = jm.forward(jp, jnp.asarray(toks.numpy()), jcfg)
        _close_rel(got, want)

    def test_every_pair_once(self):
        """Each (token, expert) assignment is computed exactly once:
        the grouped products see T x K rows, in expert order."""
        jcfg, jp, tcfg, tp = _pair("dropless", seed=5)
        calls = []
        orig = tm._grouped_products

        def spy(x, w, offs, e_s):
            calls.append((x.shape[0], offs.tolist(), e_s.tolist()))
            return orig(x, w, offs, e_s)

        tm._grouped_products = spy
        try:
            tm.forward(tp, torch.from_numpy(_tokens(63, 2, 5)), tcfg)
        finally:
            tm._grouped_products = orig
        A = 2 * 5 * tcfg.top_k
        assert len(calls) == 3 * tcfg.n_layers
        for rows, offs, e_s in calls:
            assert rows == A and offs[-1] == A
            assert e_s == sorted(e_s)
            counts = np.bincount(e_s, minlength=tcfg.n_experts)
            assert np.cumsum(counts).tolist() == offs

    def test_grouped_products_per_expert_fallback(self):
        """The grouped GEMM (aligned rows) and the per-expert products
        it falls back to (rows not 16-byte aligned; no group size on the
        host) each give every row its own expert's product."""
        rng = np.random.default_rng(6)
        e_s = torch.tensor([0, 0, 1, 2, 2, 2, 2])
        offs = torch.tensor([2, 3, 7], dtype=torch.int32)
        for k, n, grouped in ((8, 4, True), (8, 5, False), (7, 4, False)):
            x = torch.from_numpy(rng.normal(size=(7, k)).astype(np.float32))
            w = torch.from_numpy(
                rng.normal(size=(3, k, n)).astype(np.float32))
            want = torch.stack([x[i] @ w[int(e_s[i])] for i in range(7)])
            assert tm._grouped_mm_fits(x, w) == grouped
            for got in (tm._grouped_products(x, w, offs, e_s),
                        tm._per_expert_products(x, w, e_s)):
                np.testing.assert_allclose(got.numpy(), want.numpy(),
                                           rtol=1e-5, atol=1e-5)

    def test_int8_leaves_widen_with_one_warning(self):
        """Like the reference: int8 expert leaves under dropless warn
        once, then widen in-graph (dequant_hook's math)."""
        jcfg, jp, tcfg, tp = _pair("dropless", seed=7)
        jqp, tqp = jq.quantize_params(jp, jcfg), tq.quantize_params(tp, tcfg)
        toks = _tokens(64, 2, 7)
        jm._Q8_ROUTING_WARNED.discard("dropless")
        tm._Q8_ROUTING_WARNED.discard("dropless")
        with pytest.warns(RuntimeWarning, match="dropless"):
            want, _ = jm.forward(jqp, jnp.asarray(toks), jcfg,
                                 layers_hook=jq.fused_expert_hook(jcfg))
        with pytest.warns(RuntimeWarning, match="dropless"):
            got, _ = tm.forward(tqp, torch.from_numpy(toks), tcfg,
                                layers_hook=tq.fused_expert_hook(tcfg))
        _close_rel(got, want)
        wide, _ = tm.forward(tqp, torch.from_numpy(toks), tcfg,
                             layers_hook=tq.dequant_hook(tcfg))
        np.testing.assert_allclose(got.numpy(), wide.numpy(), rtol=1e-6,
                                   atol=1e-6)

    def test_server_one_fetch_per_tick(self):
        """Dropless reads no group size on the host: a served tick is
        one fetch, fused ticks too."""
        _, _, tcfg, tp = _pair("dropless", seed=8)
        srv = tm.MoESlotServer(tp, tcfg, n_slots=3, max_len=40, device="cpu")
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


class TestExpertChoice:
    def test_every_expert_processes_exactly_capacity(self):
        """TestExpertChoice's first-principles case: each expert applies
        itself to exactly its C top-scoring tokens, weighted by the
        score; the port equals the numpy recomputation and the JAX
        dispatch."""
        import math

        from tpushare.models.transformer import ParallelCtx
        rng = np.random.default_rng(7)
        B, S, Dm, F, E = 1, 8, 4, 6, 4
        jcfg = jm.tiny(d_model=Dm, d_ff=F, n_experts=E, top_k=2,
                       remat=False, routing="expert_choice")
        tcfg = bridge.moe_config_from_jax(jcfg)
        T = B * S
        C = tm.expert_capacity(T, tcfg, default_factor=1.0)
        assert C == math.ceil(T * tcfg.top_k / E) == 4
        h = rng.normal(size=(B, S, Dm)).astype(np.float32)
        probs = rng.random((B, S, E)).astype(np.float32)
        layer = {k: (rng.normal(size=shp) * 0.3).astype(np.float32)
                 for k, shp in (("w_gate", (E, Dm, F)), ("w_up", (E, Dm, F)),
                                ("w_down", (E, F, Dm)))}
        got = tm._expert_choice_dispatch(
            torch.from_numpy(h), {k: torch.from_numpy(v)
                                  for k, v in layer.items()},
            tcfg, torch.from_numpy(probs), False)
        want = jm._expert_choice_dispatch(
            jnp.asarray(h), {k: jnp.asarray(v) for k, v in layer.items()},
            jcfg, ParallelCtx(), None, jnp.asarray(probs))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-6)
        p, x = probs.reshape(T, E), h.reshape(T, Dm)
        expected = np.zeros((T, Dm), np.float32)
        for e in range(E):
            for t in np.argsort(-p[:, e], kind="stable")[:C]:
                g = x[t] @ layer["w_gate"][e]
                ff = (g / (1 + np.exp(-g))) * (x[t] @ layer["w_up"][e])
                expected[t] += p[t, e] * (ff @ layer["w_down"][e])
        np.testing.assert_allclose(got.numpy().reshape(T, Dm), expected,
                                   rtol=2e-5, atol=2e-6)

    def test_ties_go_to_the_lower_token(self):
        """Tied scores over tokens: both packages' experts pick the same
        (lower-index) tokens."""
        from tpushare.models.transformer import ParallelCtx
        rng = np.random.default_rng(8)
        jcfg = jm.tiny(d_model=4, d_ff=6, n_experts=4, top_k=1,
                       remat=False, routing="expert_choice")
        tcfg = bridge.moe_config_from_jax(jcfg)
        probs = np.full((1, 8, 4), 0.25, np.float32)      # all tied
        probs[0, 5, 2] = 0.4
        h = rng.normal(size=(1, 8, 4)).astype(np.float32)
        layer = {k: (rng.normal(size=shp) * 0.3).astype(np.float32)
                 for k, shp in (("w_gate", (4, 4, 6)), ("w_up", (4, 4, 6)),
                                ("w_down", (4, 6, 4)))}
        got = tm._expert_choice_dispatch(
            torch.from_numpy(h), {k: torch.from_numpy(v)
                                  for k, v in layer.items()},
            tcfg, torch.from_numpy(probs), False)
        want = jm._expert_choice_dispatch(
            jnp.asarray(h), {k: jnp.asarray(v) for k, v in layer.items()},
            jcfg, ParallelCtx(), None, jnp.asarray(probs))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-6)
        # C = 2: tokens 0 and 1 for the tied experts; expert 2 takes
        # token 5 first, then token 0. Tokens 2-4, 6, 7 stay untouched.
        out = got.numpy()[0]
        assert (out[[2, 3, 4, 6, 7]] == 0).all()
        assert (np.abs(out[[0, 1, 5]]) > 0).all()

    def test_forward_aux_exactly_zero(self):
        _, _, tcfg, tp = _pair("expert_choice", seed=9)
        logits, aux = tm.forward(tp, torch.from_numpy(_tokens(65, 2, 9)),
                                 tcfg)
        assert float(aux) == 0.0 and torch.isfinite(logits).all()


class TestPhaseTimer:
    def _decode(self, mod, params, cfg, hook, toks, pos, timer, cache,
                torch_side):
        if torch_side:
            return tm.forward(params, torch.from_numpy(toks), cfg,
                              cache=cache,
                              pos_offset=torch.from_numpy(pos),
                              layers_hook=hook, phase_timer=timer)
        return jm.forward(params, jnp.asarray(toks), cfg, cache=cache,
                          pos_offset=jnp.asarray(pos), layers_hook=hook,
                          phase_timer=timer)

    @pytest.mark.parametrize("routing,capacity", [("psum", None),
                                                  ("psum", 1.5),
                                                  ("dropless", None),
                                                  ("expert_choice", None)])
    def test_same_spans_in_the_same_order(self, routing, capacity,
                                          monkeypatch):
        """TestPhaseTimerSeam's decode step: both packages mark the same
        phases in the same order (embed, per layer dequant / attn /
        router / dispatch / expert_gemm, kv_stack, unembed)."""
        jcfg, jp, tcfg, tp = _pair(routing, capacity, seed=10)
        jqp, tqp = jq.quantize_params(jp, jcfg), tq.quantize_params(tp, tcfg)
        names = {"jax": [], "torch": []}
        for side, cls in (("jax", jprof.PhaseTimer),
                          ("torch", tprof.PhaseTimer)):
            orig = cls.mark

            def mark(self, phase, block_on=None, _o=orig, _s=side):
                names[_s].append(phase)
                return _o(self, phase, block_on=block_on)
            monkeypatch.setattr(cls, "mark", mark)
        toks = _tokens(66, 2, 1)
        pos = np.array([3, 5], np.int32)
        jt_ = jprof.PhaseTimer()
        jt_.start()
        jl, _, _ = self._decode(jm, jqp, jcfg, jq.dequant_hook(jcfg), toks,
                                pos, jt_, jm.init_cache(jcfg, 2, 16), False)
        tt_ = tprof.PhaseTimer()
        tt_.start()
        tl, _, _ = self._decode(tm, tqp, tcfg, tq.dequant_hook(tcfg), toks,
                                pos, tt_, tm.init_cache(tcfg, 2, 16,
                                                        device="cpu"), True)
        assert names["torch"] == names["jax"]
        assert {"embed", "dequant", "attn", "router", "expert_gemm",
                "unembed"} <= set(names["torch"])
        snap = tt_.snapshot()
        assert sum(r["fraction"] for r in snap.values()) == \
            pytest.approx(1.0, abs=0.01)
        _close_rel(tl, jl)

    def test_logits_and_streams_unchanged_with_the_timer(self):
        jcfg, jp, tcfg, tp = _pair(seed=11)
        tqp = tq.quantize_params(tp, tcfg)
        hook = tq.fused_expert_hook(tcfg)
        toks = torch.from_numpy(_tokens(67, 2, 9))
        a, _ = tm.forward(tqp, toks, tcfg, layers_hook=hook)
        pt = tprof.PhaseTimer()
        pt.start()
        b, _ = tm.forward(tqp, toks, tcfg, layers_hook=hook, phase_timer=pt)
        assert torch.equal(a, b)
        streams = {}
        for name, timer in (("off", None), ("on", tprof.PhaseTimer())):
            srv = tm.MoESlotServer(tqp, tcfg, n_slots=2, max_len=64,
                                   layers_hook=hook, phase_timer=timer,
                                   device="cpu")
            srv.admit(np.arange(6))
            streams[name] = [sorted(srv.step().items()) for _ in range(4)]
            if timer is not None:
                assert timer.snapshot()
        assert streams["on"] == streams["off"]

    def test_excluded_from_the_serving_cli(self):
        """As tests/test_sync_free.py holds the JAX engine: no flag
        spells measurement mode and the module never names the seam."""
        flags = [s for a in tserve.build_parser()._actions
                 for s in a.option_strings]
        assert not any("phase" in f for f in flags)
        assert "phase_timer" not in inspect.getsource(tserve)


def test_quantized_forward_vs_jax():
    jcfg = jt.tiny(remat=False)
    jp = jt.init_params(jax.random.PRNGKey(12), jcfg)
    tcfg, tp = bridge.config_from_jax(jcfg), bridge.params_from_jax(
        jp, device="cpu")
    toks = _tokens(68, 2, 9, vocab=jcfg.vocab_size)
    want, _ = jq.quantized_forward(jq.quantize_params(jp, jcfg),
                                   jnp.asarray(toks), jcfg)
    got, _ = tq.quantized_forward(tq.quantize_params(tp, tcfg),
                                  torch.from_numpy(toks), tcfg)
    _close_rel(got, want)
    ref, _ = tt.forward(tq.quantize_params(tp, tcfg), torch.from_numpy(toks),
                        tcfg, layers_hook=tq.dequant_hook(tcfg))
    assert torch.equal(got, ref)


# -- MoE speculation: the servers against the JAX package's -------------

DRAFTS = ["int8-fused", "int8-dequant", "mismatched"]


def _drafts(which, jcfg, jp, tcfg, tp):
    """(jax draft, jax hook, port draft, port hook) of one draft kind."""
    if which == "mismatched":
        jd = jm.init_params(jax.random.PRNGKey(77), jcfg)
        return (jd, jcfg), None, (bridge.params_from_jax(
            jd, device="cpu"), tcfg), None
    hook = "fused_expert_hook" if which == "int8-fused" else "dequant_hook"
    return ((jq.quantize_params(jp, jcfg), jcfg), getattr(jq, hook)(jcfg),
            (tq.quantize_params(tp, tcfg), tcfg), getattr(tq, hook)(tcfg))


SPEC_SERVERS = {f"{kind}-{d}": (kind, d) for kind in ("rows", "paged")
                for d in DRAFTS}


@pytest.fixture(scope="module", params=list(SPEC_SERVERS))
def spec_logs(request):
    kind, which = SPEC_SERVERS[request.param]
    jcfg, jp, tcfg, tp = _pair(seed=6)
    jd, jh, td, th = _drafts(which, jcfg, jp, tcfg, tp)
    jkw = dict(prefix_cache=True, speculative_draft=jd, gamma=2,
               draft_layers_hook=jh)
    tkw = dict(prefix_cache=True, speculative_draft=td, gamma=2,
               draft_layers_hook=th)
    if kind == "paged":
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
    return jlog, tlog, jsrv, tsrv, which


class TestSpecServerParity:
    def test_token_streams_equal(self, spec_logs):
        """Whole, prefix-hit, chunked and fused admissions, evict and
        re-admit, speculative rounds between them: equal streams."""
        jlog, tlog, _, tsrv, _ = spec_logs
        kinds = [e[0] for e in tlog]
        assert kinds.count("fused") >= 4 and "serial" in kinds
        assert any(isinstance(t, list) for e in tlog if e[0] == "step"
                   for _, t in e[1])                 # rounds ran
        assert tlog == jlog

    def test_round_counters_agree(self, spec_logs):
        _, _, jsrv, tsrv, which = spec_logs
        assert tsrv.spec_rounds == jsrv.spec_rounds > 0
        assert tsrv.spec_accepted_tokens == jsrv.spec_accepted_tokens
        assert tsrv.device_fetches == jsrv.device_fetches
        np.testing.assert_array_equal(tsrv.active, jsrv.active)
        if which != "mismatched":
            assert tsrv.spec_accept_rate() > 0.5     # int8-self

    def test_streams_equal_the_plain_server(self, spec_logs):
        """TestMoESpecServer's check: the draft changes speed, never
        output — two prompts drained through rounds equal a plain
        server's streams."""
        _, _, _, tsrv, which = spec_logs
        jcfg, jp, tcfg, tp = _pair(seed=6)
        _, _, td, th = _drafts(which, jcfg, jp, tcfg, tp)
        rng = np.random.default_rng(51)
        prompts = [rng.integers(0, 256, n) for n in (6, 9)]

        def drain(**kw):
            if isinstance(tsrv, tm.MoESlotServer):
                srv = tm.MoESlotServer(tp, tcfg, n_slots=2, max_len=64,
                                       device="cpu", **kw)
            else:
                srv = paged.PagedSlotServer(
                    tp, tcfg, n_slots=2, n_blocks=48, block_size=4,
                    forward_fn=tm.paged_forward, device="cpu", **kw)
            slots = [srv.admit(p) for p in prompts]
            got = {s: [int(srv.last_token[s, 0])] for s in slots}
            while any(len(v) < 12 for v in got.values()):
                for s, t in srv.step().items():
                    got[s].extend(t if isinstance(t, list) else [t])
            return [got[s][:12] for s in slots]

        assert drain(speculative_draft=td, gamma=3,
                     draft_layers_hook=th) == drain()


class TestSpecServerEdges:
    def test_fallback_near_max_len(self):
        """The reference's capacity case: rounds while the whole block
        fits, then plain ticks on the same slot, retiring at max_len;
        equal to the JAX server's stream."""
        jcfg, jp, tcfg, tp = _pair(seed=13, scale=1.0)
        jd = (jm.init_params(jax.random.PRNGKey(7), jcfg), jcfg)
        td = (bridge.params_from_jax(jd[0], device="cpu"), tcfg)
        prompt = np.array([5, 4, 3, 2, 1, 0, 9, 8])
        out = {}
        for side in ("jax", "torch"):
            srv = (jm.MoESlotServer(jp, jcfg, n_slots=1, max_len=13,
                                    speculative_draft=jd, gamma=3)
                   if side == "jax" else
                   tm.MoESlotServer(tp, tcfg, n_slots=1, max_len=13,
                                    speculative_draft=td, gamma=3,
                                    device="cpu"))
            s = srv.admit(jnp.asarray(prompt) if side == "jax" else prompt)
            got, kinds = [int(srv.last_token[s, 0])], set()
            while srv.active[s]:
                t = srv.step().get(s)
                if t is None:
                    break
                kinds.add(type(t))
                got.extend(t if isinstance(t, list) else [t])
            out[side] = (got, kinds)
        assert out["torch"] == out["jax"]
        assert out["torch"][1] == {list, int}        # both regimes
        assert srv._lengths_np[0] == 13

    @pytest.mark.parametrize("server", ["rows", "paged"])
    def test_one_fetch_per_round_and_fused_tick(self, server):
        jcfg, jp, tcfg, tp = _pair(seed=14)
        tqp = tq.quantize_params(tp, tcfg)
        kw = dict(speculative_draft=(tqp, tcfg), gamma=2,
                  draft_layers_hook=tq.fused_expert_hook(tcfg),
                  device="cpu")
        if server == "rows":
            srv = tm.MoESlotServer(tp, tcfg, n_slots=3, max_len=64, **kw)
        else:
            srv = paged.PagedSlotServer(tp, tcfg, n_slots=3, n_blocks=48,
                                        block_size=4,
                                        forward_fn=tm.paged_forward, **kw)
        srv.admit(np.arange(6))
        slot = srv.admit_start(np.arange(20, 31), chunk_tokens=4)
        counts = []
        with count_fetches(counts):
            for _ in range(3):
                counts.append(0)
                assert isinstance(srv.step()[0], list)
            while slot in srv._admissions:
                counts.append(0)
                srv.step(prefill_work=slot)
            counts.append(0)
            srv.step()
        assert counts == [1] * len(counts), counts

    def test_draft_forward_fn_names_the_drafts_family(self):
        """draft_forward_fn: a dense draft for an MoE target over the
        same pool; the draft's decode, prefill and verify all go
        through it, and greedy output is the target's."""
        jcfg, jp, tcfg, tp = _pair(seed=15)
        dcfg = bridge.config_from_jax(jt.tiny(remat=False,
                                              vocab_size=jcfg.vocab_size))
        dp = tt.init_params(3, dcfg, device="cpu")
        calls = []

        def dfwd(*a, **kw):
            calls.append(a[1].shape)
            return tt.forward(*a, **kw)

        srv = paged.PagedSlotServer(
            tp, tcfg, n_slots=2, n_blocks=32, block_size=4,
            forward_fn=tm.paged_forward, speculative_draft=(dp, dcfg),
            draft_forward_fn=dfwd, gamma=2, device="cpu")
        plain = paged.PagedSlotServer(tp, tcfg, n_slots=2, n_blocks=32,
                                      block_size=4,
                                      forward_fn=tm.paged_forward,
                                      device="cpu")
        p = np.arange(3, 12)
        s, r = srv.admit(p), plain.admit(p)
        got = [int(srv.last_token[s, 0])]
        while len(got) < 10:
            got.extend(srv.step()[s])
        want = [int(plain.last_token[r, 0])] + [plain.step()[r]
                                                for _ in range(9)]
        assert got[:10] == want
        shapes = {tuple(c) for c in calls}
        assert (1, 12) in shapes or any(c[0] == 1 for c in shapes)  # prefill
        assert (2, 1) in shapes                                      # decode


def _null_tv(p, n, reps=200, seed=0):
    rng = np.random.default_rng(seed)
    tvs = [0.5 * np.abs(rng.multinomial(n, p) / n - p).sum()
           for _ in range(reps)]
    return float(np.mean(tvs)), float(np.std(tvs))


class TestStochasticMoESpeculation:
    """test_spec_seam.py::TestStochasticMoESpeculation's server-level
    cases on the port: the oracle's TV bound, full acceptance of a
    perfect draft, reproducibility."""

    def _server(self, tp, tcfg, **kw):
        kw.setdefault("n_slots", 2)
        kw.setdefault("max_len", 64)
        kw.setdefault("temperature", 1.0)
        kw.setdefault("gamma", 3)
        return tm.MoESlotServer(tp, tcfg, device="cpu",
                                speculative_draft=kw.pop("draft",
                                                         (tp, tcfg)), **kw)

    def test_server_round_token_law_matches_target(self):
        """The round's first emitted token after a pinned pending token
        follows the JAX target's exact conditional softmax."""
        jcfg, jp, tcfg, tp = _pair(seed=0, scale=1.0)
        prompt = np.random.default_rng(21).integers(0, 256, 7)
        pin = 3
        ext = jnp.asarray(np.concatenate([prompt, [pin]]), jnp.int32)
        tlog, _, _ = jm.forward(jp, ext[None, :], jcfg,
                                cache=jm.init_cache(jcfg, 1, 16),
                                pos_offset=0, last_logit_only=True)
        p_true = np.asarray(jax.nn.softmax(tlog[0, 0]), np.float64)
        p_true /= p_true.sum()
        tqp = tq.quantize_params(tp, tcfg)
        srv = self._server(tp, tcfg, n_slots=1, gamma=1, seed=11,
                           draft=(tqp, tcfg),
                           draft_layers_hook=tq.dequant_hook(tcfg))
        n, toks = 220, []
        for _ in range(n):
            s = srv.admit(prompt)
            srv.last_token[s, 0] = pin
            toks.append(srv.step()[s][0])
            srv.evict(s)
        hist = np.bincount(np.asarray(toks), minlength=256).astype(float)
        tv = 0.5 * np.abs(hist / n - p_true).sum()
        mu, sd = _null_tv(p_true, n)
        assert tv < mu + 4 * sd, f"TV {tv} vs null {mu}+-{sd}"

    def test_perfect_draft_always_accepts(self):
        _, _, tcfg, tp = _pair(seed=0, scale=1.0)
        srv = self._server(tp, tcfg, seed=5)
        slot = srv.admit(np.random.default_rng(22).integers(0, 256, 9))
        for round_i in range(4):
            out = srv.step()
            assert len(out[slot]) == 4, (round_i, out)

    def test_stream_reproducible_and_in_vocab(self):
        _, _, tcfg, tp = _pair(seed=0, scale=1.0)
        tqp = tq.quantize_params(tp, tcfg)

        def run(seed):
            srv = self._server(tp, tcfg, draft=(tqp, tcfg),
                               draft_layers_hook=tq.dequant_hook(tcfg),
                               temperature=0.8, seed=seed)
            slot = srv.admit(np.random.default_rng(23).integers(0, 256, 11))
            out = [int(srv.last_token[slot, 0])]
            while len(out) < 12:
                out.extend(srv.step()[slot])
            return out[:12]

        a, b, c = run(7), run(7), run(8)
        assert a == b and a != c
        assert all(0 <= t < 256 for t in a)

    def test_paged_stochastic_rounds_in_vocab(self):
        _, _, tcfg, tp = _pair(seed=0, scale=1.0)
        srv = paged.PagedSlotServer(
            tp, tcfg, n_slots=2, n_blocks=32, block_size=4,
            forward_fn=tm.paged_forward, temperature=1.0, seed=3,
            speculative_draft=(tp, tcfg), gamma=2, device="cpu")
        slot = srv.admit(np.arange(5, 14))
        for _ in range(3):
            toks = srv.step()[slot]
            assert len(toks) == 3 and all(0 <= t < 256 for t in toks)

    def test_max_len_clamp_stochastic(self):
        _, _, tcfg, tp = _pair(seed=0, scale=1.0)
        srv = self._server(tp, tcfg, n_slots=1, max_len=16, gamma=2,
                           spec_horizon=2)
        slot = srv.admit(np.random.default_rng(25).integers(0, 256, 8))
        while srv.active[slot]:
            srv.step()
        assert int(srv.lengths[slot]) <= srv.max_len


# -- the engine ------------------------------------------------------------

def _to_jax(tree):
    """A port params tree back to jnp (the JAX engine's oracle runs on
    the weights build_engine drew)."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


@pytest.mark.parametrize("kv", ["rows", "paged"])
def test_build_engine_moe_int8_self_matches_jax(kv):
    """``--model-family moe --draft-preset int8-self`` serves through
    the speculative servers; its streams equal the JAX engine's serial
    tick over the same weights and the same int8-self draft, and
    /stats keeps the reference's speculative keys."""
    argv = ["--device", "cpu", "--model-family", "moe", "--kv", kv,
            "--draft-preset", "int8-self", "--gamma", "3", "--n-slots",
            "2", "--seed", "4"]
    argv += (["--max-len", "64"] if kv == "rows"
             else ["--n-blocks", "48", "--block-size", "4"])
    teng = tserve.build_engine(tserve.build_parser().parse_args(argv))
    srv = teng.srv._inner if kv == "rows" else teng.srv
    assert srv.speculative
    jp = _to_jax(srv.params)
    jcfg = jm.tiny(remat=False)
    opts = dict(n_slots=2, model_family="moe", kv=kv, idle_sleep_s=0.001,
                chaos_spec="", gamma=3, overlap_tick=False,
                speculative_draft=(jq.quantize_params(jp, jcfg), jcfg),
                draft_layers_hook=jq.fused_expert_hook(jcfg))
    opts.update(max_len=64) if kv == "rows" else opts.update(
        n_blocks=48, block_size=4)
    jeng = jserve.ServeEngine(jp, jcfg, **opts)
    rng = np.random.default_rng(31)
    prompts = [[int(t) for t in rng.integers(0, 256, n)] for n in (6, 11, 9)]
    streams, stats = {}, {}
    for which, eng, mod in (("jax", jeng, jserve), ("torch", teng, tserve)):
        reqs = _drive(eng, [_request(mod, p, 8) for p in prompts])
        streams[which] = [r.tokens for r in reqs]
        stats[which] = eng.stats()
        eng.stop()
    assert streams["torch"] == streams["jax"]
    spec_t, spec_j = stats["torch"]["speculative"], stats["jax"][
        "speculative"]
    assert set(spec_t) == set(spec_j)
    assert spec_t["spec_rounds"] > 0 and spec_t["spec_accept_rate"] > 0
    assert stats["torch"]["device_fetches"] == stats["torch"]["work_ticks"]
    assert (stats["torch"]["free_blocks"] is None) == (kv == "rows")


@pytest.mark.parametrize("kv", ["rows", "paged"])
def test_moe_engine_refuses_adapters_in_the_reference_words(kv):
    jcfg = jm.tiny(remat=False)
    tcfg = bridge.moe_config_from_jax(jcfg)
    tp = tm.init_params(0, tcfg, device="cpu")
    opts = dict(model_family="moe", kv=kv, multi_lora={}, chaos_spec="")
    words = {"rows": "does not support \\['multi_lora'\\]",
             "paged": "does not support kv_quant/multi_lora"}[kv]
    with pytest.raises(ValueError, match=words):
        tserve.ServeEngine(tp, tcfg, device="cpu", **opts)
    with pytest.raises(ValueError, match=words):
        jserve.ServeEngine(jm.init_params(jax.random.PRNGKey(0), jcfg),
                           jcfg, **opts)
