"""The port's BERT encoder (``tpushare_torch/models/bert.py``) against the
JAX package's ``tpushare/models/bert.py`` on ``tiny()``: the same
weights (``bridge.bert_params_from_jax`` of a JAX ``init_params`` tree),
the same seeded tokens, in f32, with and without segment ids and an
attention mask. Tolerance 2e-5 absolute on hidden states and pooled
output: both sides compute in f32 (JAX on the CPU, attention through
``mha_reference`` in both) and differ by summation order only, ~1e-6 at
these widths.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.models import bert as jbert
from tpushare_torch.models import bert as tbert
from tpushare_torch.models import bridge

TOL = 2e-5


@pytest.fixture(scope="module")
def weights():
    cfg = jbert.tiny()
    params = jbert.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, params, bridge.bert_params_from_jax(params, device="cpu"), \
        bridge.bert_config_from_jax(cfg)


def _inputs(cfg, seed, B=3, S=24):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S))
    segments = rng.integers(0, cfg.n_segments, (B, S))
    mask = np.ones((B, S), np.int32)
    mask[1, S // 2:] = 0
    mask[2, 5:] = 0
    return tokens, segments, mask


@pytest.mark.parametrize("segments,masked", [(False, False), (True, False),
                                             (False, True), (True, True)])
@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_jax(weights, segments, masked, seed):
    jcfg, jp, tp, tcfg = weights
    tokens, seg, mask = _inputs(jcfg, seed)
    jkw, tkw = {}, {}
    if segments:
        jkw["segment_ids"], tkw["segment_ids"] = jnp.asarray(seg), \
            torch.as_tensor(seg)
    if masked:
        jkw["attention_mask"], tkw["attention_mask"] = jnp.asarray(mask), \
            torch.as_tensor(mask)
    want = jbert.forward(jp, jnp.asarray(tokens), jcfg, **jkw)
    got = tbert.forward(tp, torch.as_tensor(tokens), tcfg, **tkw)
    for key in ("hidden", "pooled"):
        w, g = np.asarray(want[key]), got[key].numpy()
        assert g.shape == w.shape and g.dtype == np.float32
        assert np.abs(g - w).max() <= TOL, (key, np.abs(g - w).max())


def test_reference_attention_is_the_auto_path(weights):
    """Non-causal attention takes mha_reference under "auto" too (the
    kernel is causal, and takes head dim 128 or 256 only)."""
    jcfg, _, tp, tcfg = weights
    tokens, _, mask = _inputs(jcfg, 2)
    t = torch.as_tensor(tokens)
    for kw in ({}, {"attention_mask": torch.as_tensor(mask)}):
        a = tbert.forward(tp, t, tcfg, **kw)["pooled"]
        r = tbert.forward(tp, t, tcfg, attn_impl="reference", **kw)["pooled"]
        assert torch.equal(a, r)


@pytest.mark.parametrize("batch,seq", [(8, 128), (2, 32), (1, 512)])
def test_flops_per_forward_equal(batch, seq):
    for j, t in ((jbert.bert_base(), tbert.bert_base()),
                 (jbert.tiny(), tbert.tiny())):
        assert tbert.flops_per_forward(t, batch, seq) == \
            jbert.flops_per_forward(j, batch, seq)


def test_configs_equal():
    for j, t in ((jbert.bert_base(), tbert.bert_base()),
                 (jbert.tiny(), tbert.tiny())):
        jd = {k: v for k, v in dataclasses.asdict(j).items() if k != "dtype"}
        td = {k: v for k, v in dataclasses.asdict(t).items() if k != "dtype"}
        assert td == jd and t.head_dim == j.head_dim
        assert str(t.dtype).split(".")[-1] == np.dtype(j.dtype).name
    assert bridge.bert_config_from_jax(jbert.bert_base()) == tbert.bert_base()


def test_init_params_tree_and_statistics():
    """The port's init has the JAX tree's keys and shapes, zero biases,
    unit norms, and weights in [-2, 2] / sqrt(fan_in) from one seed."""
    cfg = tbert.tiny()
    jtree = jax.tree_util.tree_map(np.shape, jbert.init_params(
        jax.random.PRNGKey(0), jbert.tiny()))
    p = tbert.init_params(0, cfg, device="cpu")
    assert {g: {k: tuple(v.shape) for k, v in d.items()}
            for g, d in p.items()} == jtree
    assert torch.equal(p["layers"]["bq"], torch.zeros_like(p["layers"]["bq"]))
    assert torch.equal(p["layers"]["ln1_scale"],
                       torch.ones_like(p["layers"]["ln1_scale"]))
    w1 = p["layers"]["w1"]
    assert w1.abs().max() <= 2 / cfg.d_model ** 0.5
    again = tbert.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    assert torch.equal(again["layers"]["w1"], w1)


def test_bridge_refuses_a_tree_that_is_not_bert():
    with pytest.raises(ValueError, match="pooler"):
        bridge.bert_params_from_jax({"embed": {}, "layers": {}})
