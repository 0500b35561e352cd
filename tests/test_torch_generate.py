"""The port's generate loops against the JAX package's, on the CPU in f32:
``models/generate.py`` ``generate``, ``models/speculative.py``
(``speculative_generate``, ``speculative_sample``) and ``moe.generate``.
Weights are JAX-initialized and bridged (``models/bridge.py``).

Tolerances: greedy token streams EQUAL (to JAX's, and speculative to
plain greedy for any draft, gamma and horizon). Sampling draws come
from different generators in the two frameworks, so laws are compared:
the empirical law of 2^15 draws within TV 0.03 of the exact law
(``tests/test_torch_sampling.py``'s gate; the null TV of 2^15 draws
over these 16-token vocabularies is ~0.009).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.models import generate as jgen
from tpushare.models import moe as jm
from tpushare.models import speculative as jspec
from tpushare.models import transformer as jt

from tpushare_torch.models import bridge
from tpushare_torch.models import generate as tgen
from tpushare_torch.models import moe as tm
from tpushare_torch.models import speculative as tspec

N_DRAWS = 1 << 15
TV_BOUND = 0.03


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: these are small tensors, and
    under a loaded pytest-xdist run torch's default of one thread per
    core oversubscribes the host many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dense(seed, **kw):
    jcfg = jt.tiny(remat=False, **kw)
    jp = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, bridge.config_from_jax(jcfg), \
        bridge.params_from_jax(jp, device="cpu")


def _prompt(batch, seq, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (batch, seq))


def _tv(draws, p):
    counts = np.bincount(np.asarray(draws), minlength=len(p))
    return 0.5 * np.abs(counts / counts.sum() - p).sum()


class TestGenerate:
    @pytest.mark.parametrize("kw", [{}, {"sliding_window": 5,
                                         "attn_softcap": 20.0,
                                         "final_softcap": 15.0}])
    def test_greedy_equals_jax(self, kw):
        jcfg, jp, tcfg, tp = _dense(0, **kw)
        toks = _prompt(3, 7, jcfg.vocab_size)
        want = jgen.generate(jp, jnp.asarray(toks), jcfg, max_new_tokens=12)
        got = tgen.generate(tp, torch.tensor(toks), tcfg, max_new_tokens=12)
        assert got.shape == (3, 19) and got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_seeded_sampling_law_and_determinism(self):
        """The first sampled token's law (temperature 0.8, top-k 6) over
        2^15 rows of one prompt against softmax of JAX's filter_logits on
        JAX's logits; the same generator seed gives the same tokens; a
        top-k of 6 keeps every later token in its step's top 6 too."""
        jcfg, jp, tcfg, tp = _dense(2, vocab_size=16)
        toks = _prompt(1, 5, 16, seed=3)
        logits, _ = jt.forward(jp, jnp.asarray(toks), jcfg)
        p = np.asarray(jax.nn.softmax(jgen.filter_logits(
            logits[0, -1], 0.8, top_k=6)), np.float64)
        kw = dict(max_new_tokens=3, temperature=0.8, top_k=6)
        rows = torch.tensor(toks).expand(N_DRAWS, 5)
        out = tgen.generate(tp, rows, tcfg,
                            generator=torch.Generator().manual_seed(0), **kw)
        assert _tv(out[:, 5].numpy(), p / p.sum()) < TV_BOUND
        again = tgen.generate(tp, rows[:64], tcfg,
                              generator=torch.Generator().manual_seed(5),
                              **kw)
        twice = tgen.generate(tp, rows[:64], tcfg,
                              generator=torch.Generator().manual_seed(5),
                              **kw)
        assert torch.equal(again, twice)
        # Step 2's tokens lie in the top 6 of their own step's logits.
        with torch.no_grad():
            from tpushare_torch.models import transformer as tt
            lg, _ = tt.forward(tp, again[:, :6], tcfg)
        top = torch.topk(lg[:, -1], 6).indices
        assert bool((top == again[:, 6:7]).any(-1).all())
        with pytest.raises(ValueError, match="generator"):
            tgen.generate(tp, rows[:1], tcfg, temperature=1.0)


class TestSpeculative:
    @pytest.mark.parametrize("gamma,horizon", [(1, 1), (4, 1), (9, 1),
                                               (2, 3)])
    def test_greedy_equals_generate_for_an_imperfect_draft(self, gamma,
                                                           horizon):
        """A differently seeded draft proposes mostly wrong tokens; the
        output is plain greedy decoding's bit for bit, and JAX's
        speculative_generate's."""
        jcfg, jp, tcfg, tp = _dense(0)
        _, jd, _, td = _dense(7)
        toks = _prompt(2, 7, jcfg.vocab_size)
        want = tgen.generate(tp, torch.tensor(toks), tcfg, max_new_tokens=20)
        got = tspec.speculative_generate(tp, td, torch.tensor(toks), tcfg,
                                         max_new_tokens=20, gamma=gamma,
                                         horizon=horizon)
        assert torch.equal(got, want)
        jgot = jspec.speculative_generate(jp, jd, jnp.asarray(toks), jcfg,
                                          max_new_tokens=20, gamma=gamma,
                                          horizon=horizon)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))

    def test_small_draft_and_int8_self_draft(self):
        """A shallower, narrower draft; and the target's own int8 tree
        through dequant_hook (quantized self-speculation)."""
        from tpushare_torch.models import quant
        jcfg, jp, tcfg, tp = _dense(0)
        dj = jt.tiny(remat=False, n_layers=1, d_model=32, n_heads=2,
                     n_kv_heads=1, head_dim=16, d_ff=64)
        dp = bridge.params_from_jax(
            jt.init_params(jax.random.PRNGKey(3), dj), device="cpu")
        toks = torch.tensor(_prompt(1, 9, jcfg.vocab_size, seed=4))
        want = tgen.generate(tp, toks, tcfg, max_new_tokens=16)
        got = tspec.speculative_generate(tp, dp, toks, tcfg,
                                         bridge.config_from_jax(dj),
                                         max_new_tokens=16, gamma=5)
        assert torch.equal(got, want)
        got8 = tspec.speculative_generate(
            tp, quant.quantize_params(tp, tcfg), toks, tcfg,
            max_new_tokens=16, gamma=4,
            draft_layers_hook=quant.dequant_hook(tcfg))
        assert torch.equal(got8, want)

    def test_moe_model_equals_moe_generate(self):
        jcfg = jm.tiny(remat=False, capacity_factor=1.25)
        jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
        jd = jm.init_params(jax.random.PRNGKey(5), jcfg)
        tcfg = bridge.moe_config_from_jax(jcfg)
        tp = bridge.params_from_jax(jp, device="cpu")
        td = bridge.params_from_jax(jd, device="cpu")
        toks = torch.tensor(_prompt(2, 6, jcfg.vocab_size, seed=2))
        want = tm.generate(tp, toks, tcfg, max_new_tokens=12)
        got = tspec.speculative_generate(tp, td, toks, tcfg,
                                         max_new_tokens=12, gamma=3,
                                         model="moe")
        assert torch.equal(got, want)

    def test_refusals(self):
        jcfg, _, tcfg, tp = _dense(0)
        toks = torch.tensor(_prompt(1, 4, jcfg.vocab_size))
        other = dataclasses.replace(tcfg, vocab_size=tcfg.vocab_size + 1)
        with pytest.raises(ValueError, match="vocabulary"):
            tspec.speculative_generate(tp, tp, toks, tcfg, other)
        with pytest.raises(ValueError, match="gamma"):
            tspec.speculative_generate(tp, tp, toks, tcfg, gamma=0)
        with pytest.raises(ValueError, match="horizon"):
            tspec.speculative_generate(tp, tp, toks, tcfg, horizon=0)
        with pytest.raises(ValueError, match="greedy"):
            tspec.speculative_sample(tp, tp, toks, tcfg, generator=None,
                                     temperature=0.0)
        with pytest.raises(ValueError, match="family"):
            tspec.speculative_generate(tp, tp, toks, tcfg, model="rnn")


class TestSpeculativeSample:
    def _law2(self, jp, jcfg, toks):
        """Exact laws of the first two sampled tokens at temperature 1:
        p1 = softmax of the prompt's last logits, p2 = sum_t p1(t)
        softmax(logits after prompt + t)."""
        logits, _ = jt.forward(jp, jnp.asarray(toks), jcfg)
        p1 = np.asarray(jax.nn.softmax(logits[0, -1]), np.float64)
        V = jcfg.vocab_size
        ext = jnp.concatenate([jnp.broadcast_to(jnp.asarray(toks), (V, 5)),
                               jnp.arange(V)[:, None]], axis=1)
        l2, _ = jt.forward(jp, ext, jcfg)
        p2 = (p1[:, None] * np.asarray(jax.nn.softmax(l2[:, -1]),
                                       np.float64)).sum(0)
        return p1 / p1.sum(), p2 / p2.sum()

    def test_first_two_token_laws_are_the_targets(self):
        """2^15 lockstep rows of one prompt with a mismatched draft: the
        first token (the prefill's draw) and the second (a round's
        accept / residual draw) follow the target's exact laws."""
        jcfg, jp, tcfg, tp = _dense(0, vocab_size=16)
        _, _, _, td = _dense(11, vocab_size=16)
        toks = _prompt(1, 5, 16, seed=3)
        p1, p2 = self._law2(jp, jcfg, toks)
        out = tspec.speculative_sample(
            tp, td, torch.tensor(toks).expand(N_DRAWS, 5), tcfg,
            generator=torch.Generator().manual_seed(1), max_new_tokens=3,
            gamma=2, temperature=1.0)
        assert out.shape == (N_DRAWS, 8)
        assert _tv(out[:, 5].numpy(), p1) < TV_BOUND
        assert _tv(out[:, 6].numpy(), p2) < TV_BOUND

    def test_the_gate_has_power(self):
        """The draft's law in place of the target's (a sampler that
        accepted every draft) fails the same gate."""
        jcfg, jp, tcfg, tp = _dense(0, vocab_size=16)
        _, jd, _, td = _dense(11, vocab_size=16)
        toks = _prompt(1, 5, 16, seed=3)
        p1, _ = self._law2(jp, jcfg, toks)
        out = tgen.generate(td, torch.tensor(toks).expand(N_DRAWS, 5), tcfg,
                            max_new_tokens=1, temperature=1.0,
                            generator=torch.Generator().manual_seed(2))
        assert _tv(out[:, 5].numpy(), p1) > TV_BOUND


class TestMoeGenerate:
    @pytest.mark.parametrize("routing,factor", [("psum", None),
                                                ("psum", 1.25),
                                                ("dropless", None),
                                                ("expert_choice", None)])
    def test_greedy_equals_jax(self, routing, factor):
        jcfg = jm.tiny(remat=False, routing=routing, capacity_factor=factor)
        jp = jm.init_params(jax.random.PRNGKey(4), jcfg)
        toks = _prompt(2, 6, jcfg.vocab_size, seed=6)
        want = jm.generate(jp, jnp.asarray(toks), jcfg, max_new_tokens=10)
        got = tm.generate(bridge.params_from_jax(jp, device="cpu"),
                          torch.tensor(toks),
                          bridge.moe_config_from_jax(jcfg),
                          max_new_tokens=10)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
