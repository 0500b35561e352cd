"""Parity of the port's ResNet-50 (``tpushare_torch.models.resnet``) with
``tpushare.models.resnet`` on the CPU in f32, and its saturation tool
(``tpushare_torch.tools.saturation``) on the host.

- ``tiny()`` (two stages, the second entered at stride 2) against the
  JAX forward on the same weights (``bridge.resnet_params_from_jax``),
  at even and odd image sides, so that every "SAME" pad of the stem,
  the max pool and the stride-2 3x3 comes out asymmetric somewhere.
- XLA's "SAME" padding: ``same_pads`` at ResNet-50's own sides, and a
  symmetric pad in its place (PyTorch's ``padding=``) caught by the
  parity check.
- The bridge's layout; the tree's shapes against the JAX tree's;
  ``num_params``.
- ``python -m tpushare_torch.tools.saturation --device cpu --tiny`` as a
  subprocess: placement one pod per fake card, 4 units on each, 25% of
  the host's units; the tenants' records; and no card, no run.

Tolerance: logits 1e-5 abs (f32 convolutions summed in other orders,
logits of magnitude ~1).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.models import resnet as jr

from tpushare_torch.models import bridge
from tpushare_torch.models import resnet as tr

torch.set_num_threads(1)

LOGIT_ATOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(seed=0):
    cfg = jr.tiny()
    jp = jr.init_params(jax.random.PRNGKey(seed), cfg)
    # Non-trivial batch-norm affines, so a wrong channel axis shows.
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(lambda a: a + jnp.asarray(
        rng.normal(size=a.shape) * 0.1, a.dtype) if a.ndim == 1 else a, jp)
    return cfg, jp, bridge.resnet_config_from_jax(cfg), \
        bridge.resnet_params_from_jax(jp, device="cpu")


def _images(B, H, W, seed=1):
    return np.random.default_rng(seed).normal(size=(B, H, W, 3)).astype(
        np.float32)


@pytest.mark.parametrize("H,W", [(64, 64), (37, 45), (32, 30), (17, 16)])
def test_tiny_matches_jax(H, W):
    jcfg, jp, tcfg, tp = _pair()
    x = _images(2, H, W)
    want = np.asarray(jr.forward(jp, jnp.asarray(x), jcfg))
    got = tr.forward(tp, torch.tensor(x), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_ATOL)


def test_same_pads_at_resnet50_sides():
    assert tr.same_pads(224, 7, 2) == (2, 3)          # the stem
    assert tr.same_pads(112, 3, 2) == (0, 1)          # the max pool
    assert tr.same_pads(56, 3, 2) == (0, 1)           # stage 2's 3x3/2
    assert tr.same_pads(28, 3, 2) == (0, 1)
    assert tr.same_pads(56, 3, 1) == (1, 1)           # stride 1: symmetric
    assert tr.same_pads(7, 1, 1) == (0, 0)
    assert tr.same_pads(37, 7, 2) == (3, 3)           # odd side
    assert tr.same_pads(5, 9, 1) == (4, 4)


def test_a_symmetric_pad_is_caught(monkeypatch):
    """PyTorch's symmetric ``padding=k // 2`` in place of XLA's "SAME"
    keeps every output size but shifts each stride-2 window by one: the
    parity check must fail."""
    jcfg, jp, tcfg, tp = _pair()
    x = _images(2, 64, 64)
    want = np.asarray(jr.forward(jp, jnp.asarray(x), jcfg))
    monkeypatch.setattr(tr, "same_pads", lambda n, k, s: (k // 2, k // 2))
    got = tr.forward(tp, torch.tensor(x), tcfg).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() > 100 * LOGIT_ATOL


def test_bridge_layout_and_shapes():
    jcfg, jp, tcfg, tp = _pair(3)
    w = np.asarray(jp["stem"]["conv"])                 # HWIO
    got = tp["stem"]["conv"]
    assert tuple(got.shape) == (w.shape[3], w.shape[2], w.shape[0],
                                w.shape[1])
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.numpy(), w.transpose(3, 2, 0, 1))
    mine = tr.init_params(0, tcfg, device="cpu")
    assert _shapes(mine) == _shapes(tp)
    assert tr.num_params(tcfg) == sum(
        int(np.prod(shape)) for shape in _shapes(mine))
    assert tr.num_params(tr.resnet50()) == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(jax.eval_shape(
            lambda k: jr.init_params(k, jr.resnet50()),
            jax.random.PRNGKey(0))))
    # ResNet-50 at 224: ~4.1 G multiply-adds.
    assert 8.0e9 < tr.flops_per_image(tr.resnet50()) < 8.4e9
    with pytest.raises(ValueError, match="missing"):
        bridge.resnet_params_from_jax({"stem": {}}, device="cpu")


def _shapes(tree):
    """Leaf shapes of a nested dict / list tree, in walk order."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _shapes(tree[k])]
    if isinstance(tree, list):
        return [s for v in tree for s in _shapes(v)]
    return [tuple(tree.shape)]


def _run_tool(*argv, timeout=240, hide_cards=False):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    if hide_cards:
        env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "-m", "tpushare_torch.tools.saturation", *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


def test_saturation_tool_on_the_host():
    proc = _run_tool("--device", "cpu", "--tiny", "--seconds", "0.3")
    assert proc.returncode == 0, proc.stderr[-2000:]
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    assert record["failures"] == []
    a = record["A"]
    assert sorted(a["cards"].values()) == ["0", "1", "2", "3"]
    assert a["units_per_card"] == {str(i): 4 for i in range(4)}
    assert a["hbm_binpack_pct"] == 25.0 and a["advertised_devices"] == 64
    assert a["hbm_limit_bytes"] == [str(4 << 30)]
    b = record["B"]
    assert len(b["four"]) == 4 and b["grant_bytes"] == 4 << 20
    for r in [b["solo"]] + b["four"]:
        assert r["logits_finite"] and r["logit_rel_err"] <= 1e-6
        assert r["calls"] > 0 and r["hbm_breaches"] == 0
        assert r["batch"] == 2 and r["image"] == [64, 64, 3]
    assert b["hbm_binpack_pct"] == 100.0 * 16 / b["units_advertised"]
    assert b["four_over_solo"] > 0


def test_saturation_tool_needs_a_card_without_device_cpu():
    proc = _run_tool(timeout=60, hide_cards=True)
    assert proc.returncode == 2 and "no CUDA card" in proc.stderr
