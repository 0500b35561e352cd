"""The port's serving mesh, spec trees, placement contract, CLI flags and
control plane (``parallel/mesh.py``, ``parallel/sharding.py``,
``models/serving.py`` ``MeshPlacement``, ``cli/serve.py --mesh``,
``parallel/control.py``) against the JAX package's, on the CPU, in
process (the multi-rank runs are tests/test_torch_sharded_serving.py).

- ``parse_mesh_spec`` accepts and refuses what JAX's does;
  ``serving_mesh`` meshes over a prefix of the cards with a warning,
  absorbs the grant with -1, raises on a poisoned grant, and maps ranks
  past the card count onto shared cards over gloo. Rank coordinates
  follow the JAX mesh's device layout.
- Every spec tree (dense, MoE, int8, LoRA, caches) equals the JAX
  package's PartitionSpec tree, and ``shard_tree`` gives each rank
  exactly the shard JAX places on the device at its coordinates.
- Placement errors carry the reference's messages.
- The CLI's mesh flags: the reference's exits, the refusals naming
  ROADMAP A10b, and a one-rank ``--mesh tp=1`` engine that serves.
- ``follow`` and ``ShardedServer`` over a scripted control group: the
  call order, a refusal replayed as a refusal, desyncs caught both
  ways, heartbeats while idle, one stop message.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.models import lora as jlora
from tpushare.models import moe as jm
from tpushare.models import quant as jq
from tpushare.models import serving as jserving
from tpushare.models import transformer as jt
from tpushare.models.paged import PagedSlotServer as JPaged
from tpushare.parallel import make_mesh
from tpushare.parallel import parse_mesh_spec as jparse
from tpushare.parallel.sharding import shard_tree as jshard_tree

from tpushare_torch.models import bridge, lora, moe, quant, serving
from tpushare_torch.models import transformer as tt
from tpushare_torch.models.paged import PagedSlotServer
from tpushare_torch.parallel import control, sharding
from tpushare_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4,
    reason="needs XLA_FLAGS=--xla_force_host_platform_device_count=4+")

TF_CFG = jt.tiny(remat=False)
TF_PARAMS = jt.init_params(jax.random.PRNGKey(0), TF_CFG)
MOE_CFG = jm.tiny(remat=False)
MOE_PARAMS = jm.init_params(jax.random.PRNGKey(0), MOE_CFG)


def _mesh(sizes, rank=0):
    """A ServingMesh over CPU ranks, as seen from ``rank`` (no process
    group: placement and checks only)."""
    n = int(np.prod(list(sizes.values())))
    m = tmesh.ServingMesh(sizes, ["cpu"] * n)
    m.rank = rank
    return m


class TestMeshSpec:
    @pytest.mark.parametrize("spec", ["tp=2,ep=2", " tp=2 , ep=-1 ",
                                      "dp=1,tp=4"])
    def test_parse(self, spec):
        assert tmesh.parse_mesh_spec(spec) == jparse(spec)

    @pytest.mark.parametrize("bad", [
        "", "tp", "tp=0", "tp=x", "bogus=2", "tp=2,tp=4"])
    def test_parse_rejects(self, bad):
        with pytest.raises(ValueError) as want:
            jparse(bad)
        with pytest.raises(ValueError) as got:
            tmesh.parse_mesh_spec(bad)
        assert str(got.value) == str(want.value)

    def test_serving_mesh_uses_device_prefix(self, capsys):
        m = tmesh.serving_mesh({"tp": 2, "ep": 2}, devices=["cpu"] * 8)
        assert m.size == 4 and m.shape["tp"] == 2 and m.shape["ep"] == 2
        assert "idle" in capsys.readouterr().err
        assert m.transport == "gloo"

    def test_serving_mesh_wildcard_absorbs_grant(self):
        assert tmesh.serving_mesh({"tp": -1}, devices=["cpu"] * 8).size == 8
        assert tmesh.serving_mesh(devices=["cpu"] * 4).shape["tp"] == 4
        with pytest.raises(ValueError, match="cannot infer"):
            tmesh.serving_mesh({"tp": 3, "ep": -1}, devices=["cpu"] * 8)

    @pytest.mark.parametrize("var,value", [
        ("NVIDIA_VISIBLE_DEVICES", "no-gpu-has-4-units"),
        ("TPU_VISIBLE_CHIPS", "no-tpu-has-4-units")])
    def test_serving_mesh_poisoned_grant_raises(self, monkeypatch, var,
                                                value):
        from tpushare_torch.utils.tenant import AllocationError
        monkeypatch.setenv(var, value)
        with pytest.raises(AllocationError):
            tmesh.serving_mesh({"tp": 2}, devices=["cpu"] * 2)

    def test_partial_grant_on_cards_raises(self, monkeypatch):
        monkeypatch.setenv("NVIDIA_VISIBLE_DEVICES", "0,1,2")
        with pytest.raises(ValueError, match="partial grant"):
            tmesh.serving_mesh({"tp": 2}, devices=[
                torch.device("cuda", i) for i in range(2)])

    def test_transport_follows_the_card_count(self, capsys):
        cards = [torch.device("cuda", i) for i in range(4)]
        assert tmesh.serving_mesh({"tp": 2}, devices=cards).transport \
            == "nccl"
        shared = tmesh.serving_mesh({"tp": 2, "ep": 2}, devices=cards[:1])
        assert shared.cards == [cards[0]] * 4
        assert shared.transport == "gloo" and shared.n_cards == 1
        assert "share cards" in shared.describe()
        assert "share cards" in capsys.readouterr().err
        two = tmesh.serving_mesh({"tp": 4}, devices=cards[:2])
        assert two.cards == [cards[0], cards[1]] * 2

    @pytest.mark.parametrize("sizes", [{"tp": 2, "ep": 2}, {"tp": 4},
                                       {"ep": 2, "tp": 1}])
    def test_rank_layout_follows_the_jax_mesh(self, sizes):
        n = int(np.prod(list(sizes.values())))
        jmesh = make_mesh(sizes, devices=jax.devices()[:n])
        ids = [d.id for d in jax.devices()[:n]]
        m = tmesh.ServingMesh(sizes, ["cpu"] * n)
        for r in range(n):
            idx = np.argwhere(np.vectorize(lambda d: d.id)(jmesh.devices)
                              == ids[r])[0]
            assert tuple(m.coords(r)[ax] for ax in tmesh.MESH_AXES) == \
                tuple(int(i) for i in idx)

    def test_a_bound_one_rank_mesh_needs_no_group(self):
        m = tmesh.serving_mesh({"tp": 1}, devices=["cpu"]).bind()
        assert m.rank == 0 and m.axis_group("tp") is None
        assert serving.mesh_axes(m) == {}


def _spec_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_spec_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v)
    return out


SPEC_CASES = {
    "dense": (lambda: jt.param_specs(TF_CFG),
              lambda: tt.param_specs(bridge.config_from_jax(TF_CFG))),
    "dense_fsdp_untied_post": (
        lambda: jt.param_specs(jt.tiny(post_norms=True,
                                       tie_embeddings=False), fsdp="fsdp"),
        lambda: tt.param_specs(bridge.config_from_jax(jt.tiny(
            post_norms=True, tie_embeddings=False)), fsdp="fsdp")),
    "moe": (lambda: jm.param_specs(MOE_CFG),
            lambda: moe.param_specs(bridge.moe_config_from_jax(MOE_CFG))),
    "quant": (lambda: jq.quant_param_specs(TF_CFG),
              lambda: quant.quant_param_specs(
                  bridge.config_from_jax(TF_CFG))),
    "quant_moe": (lambda: jq.quant_moe_param_specs(MOE_CFG),
                  lambda: quant.quant_moe_param_specs(
                      bridge.moe_config_from_jax(MOE_CFG))),
    "lora": (lambda: jlora.lora_param_specs(
                 TF_CFG, ("wq", "wv", "wo", "w_down"), fsdp="fsdp"),
             lambda: lora.lora_param_specs(
                 None, ("wq", "wv", "wo", "w_down"), fsdp="fsdp")),
    "rows": (jserving.cache_specs, serving.cache_specs),
}


class TestSharding:
    @pytest.mark.parametrize("case", sorted(SPEC_CASES))
    def test_spec_trees_equal_the_reference(self, case):
        want, got = SPEC_CASES[case]
        assert _spec_leaves(got()) == _spec_leaves(want())

    def test_pool_spec_equals_the_reference(self):
        assert tuple(serving.paged_pool_specs()) == \
            tuple(jserving.paged_pool_specs())

    @pytest.mark.parametrize("family,sizes", [
        ("dense", {"tp": 2}), ("moe", {"ep": 2, "tp": 2}),
        ("quant_moe", {"ep": 2, "tp": 2}), ("moe", {"ep": 4})])
    def test_shard_tree_gives_each_rank_its_jax_shard(self, family, sizes):
        n = int(np.prod(list(sizes.values())))
        jmesh = make_mesh(sizes, devices=jax.devices()[:n])
        tree = {"dense": TF_PARAMS, "moe": MOE_PARAMS,
                "quant_moe": jq.quantize_params(MOE_PARAMS, MOE_CFG)}[family]
        jspecs, tspecs = SPEC_CASES[family]
        placed = jshard_tree(tree, jmesh, jspecs())
        ttree = bridge.params_from_jax(tree, device="cpu")
        specs = tspecs()
        dev_rank = {d.id: r for r, d in enumerate(jax.devices()[:n])}
        for r in range(n):
            got = sharding.shard_tree(ttree, specs, _mesh(sizes, r))
            jflat = _leaves(placed)
            for key, t in _leaves(got).items():
                shard = [s for s in jflat[key].addressable_shards
                         if dev_rank[s.device.id] == r][0]
                want = np.asarray(shard.data)
                assert tuple(t.shape) == want.shape, key
                assert t.is_contiguous()
                np.testing.assert_array_equal(t.numpy(), want, err_msg=key)
                assert sharding.local_shape(
                    jflat[key].shape, _spec_leaves(specs)[key],
                    _mesh(sizes).sizes) == want.shape

    def test_local_shape_refuses_a_cut_that_does_not_divide(self):
        with pytest.raises(ValueError, match="does not split"):
            sharding.local_shape((4, 6), sharding.P(None, "tp"), {"tp": 4})
        assert sharding.local_shape((8, 6), sharding.P(("ep", "tp")),
                                    {"ep": 2, "tp": 2}) == (2, 6)

    def test_replicated(self):
        assert sharding.replicated(sharding.P())
        assert sharding.replicated(sharding.P(None, None))
        assert not sharding.replicated(sharding.P(None, "tp"))


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _pair_raises(jfn, tfn, exc=ValueError):
    with pytest.raises(exc) as want:
        jfn()
    with pytest.raises(exc) as got:
        tfn()
    return str(got.value), str(want.value)


TCFG = bridge.config_from_jax(TF_CFG)
TPARAMS = bridge.params_from_jax(TF_PARAMS, device="cpu")
MCFG = bridge.moe_config_from_jax(MOE_CFG)
MPARAMS = bridge.params_from_jax(MOE_PARAMS, device="cpu")


class TestPlacementValidation:
    def test_tp_must_divide_kv_heads(self):
        got, want = _pair_raises(
            lambda: JPaged(TF_PARAMS, TF_CFG, n_slots=2, n_blocks=16,
                           block_size=4, mesh=make_mesh(
                               {"tp": 4}, devices=jax.devices()[:4])),
            lambda: PagedSlotServer(TPARAMS, TCFG, n_slots=2, n_blocks=16,
                                    block_size=4, mesh=_mesh({"tp": 4})))
        assert got == want and "n_kv_heads" in got

    def test_ep_must_divide_experts(self):
        if len(jax.devices()) < 6:
            pytest.skip("needs 6 forced devices for ep=3,tp=2")
        got, want = _pair_raises(
            lambda: jm.MoESlotServer(MOE_PARAMS, MOE_CFG, n_slots=2,
                                     max_len=32, mesh=make_mesh(
                                         {"ep": 3, "tp": 2},
                                         devices=jax.devices()[:6])),
            lambda: moe.MoESlotServer(MPARAMS, MCFG, n_slots=2, max_len=32,
                                      mesh=_mesh({"ep": 3, "tp": 2})))
        assert got == want and "n_experts" in got

    def test_ep_rejected_for_dense(self):
        got, want = _pair_raises(
            lambda: jserving.SlotServer(TF_PARAMS, TF_CFG, n_slots=2,
                                        max_len=32, mesh=make_mesh(
                                            {"ep": 2},
                                            devices=jax.devices()[:2])),
            lambda: serving.SlotServer(TPARAMS, TCFG, n_slots=2, max_len=32,
                                       mesh=_mesh({"ep": 2})))
        assert got == want and "expert-parallel" in got

    def test_non_serving_axes_rejected(self):
        got, want = _pair_raises(
            lambda: JPaged(TF_PARAMS, TF_CFG, n_slots=2, n_blocks=16,
                           block_size=4, mesh=make_mesh(
                               {"dp": 2}, devices=jax.devices()[:2])),
            lambda: PagedSlotServer(TPARAMS, TCFG, n_slots=2, n_blocks=16,
                                    block_size=4, mesh=_mesh({"dp": 2})))
        assert got == want and "tp/ep" in got

    def test_kv_quant_and_multi_lora_rejected(self):
        jmesh = make_mesh({"tp": 2}, devices=jax.devices()[:2])
        got, want = _pair_raises(
            lambda: JPaged(TF_PARAMS, TF_CFG, n_slots=2, n_blocks=16,
                           block_size=4, kv_quant=True, mesh=jmesh),
            lambda: PagedSlotServer(TPARAMS, TCFG, n_slots=2, n_blocks=16,
                                    block_size=4, kv_quant=True,
                                    mesh=_mesh({"tp": 2})))
        assert got == want and "kv_quant" in got
        jbank = jlora.stack_adapters([jlora.init_lora(
            jax.random.PRNGKey(1), TF_CFG, 2)])
        tbank = lora.stack_adapters([lora.init_lora(
            torch.Generator().manual_seed(1), TCFG, 2)])
        got, want = _pair_raises(
            lambda: JPaged(TF_PARAMS, TF_CFG, n_slots=2, n_blocks=16,
                           block_size=4, multi_lora=jbank, mesh=jmesh),
            lambda: PagedSlotServer(TPARAMS, TCFG, n_slots=2, n_blocks=16,
                                    block_size=4, multi_lora=tbank,
                                    mesh=_mesh({"tp": 2})))
        assert got == want and "multi_lora" in got
        with pytest.raises(ValueError, match="host_kv_bytes"):
            PagedSlotServer(TPARAMS, TCFG, n_slots=2, n_blocks=16,
                            block_size=4, host_tier=object(),
                            mesh=_mesh({"tp": 2}))

    def test_draft_heads_must_divide_too(self):
        wide = jt.tiny(remat=False, n_kv_heads=4, n_heads=4)
        wide_params = jt.init_params(jax.random.PRNGKey(2), wide)
        got, want = _pair_raises(
            lambda: JPaged(wide_params, wide, n_slots=2, n_blocks=16,
                           block_size=4, mesh=make_mesh(
                               {"tp": 4}, devices=jax.devices()[:4]),
                           speculative_draft=(TF_PARAMS, TF_CFG)),
            lambda: PagedSlotServer(
                bridge.params_from_jax(wide_params, device="cpu"),
                bridge.config_from_jax(wide), n_slots=2, n_blocks=16,
                block_size=4, mesh=_mesh({"tp": 4}),
                speculative_draft=(TPARAMS, TCFG)))
        assert got == want and "draft" in got

    def test_a_mesh_must_be_a_bound_serving_mesh(self):
        with pytest.raises(TypeError, match="ServingMesh"):
            serving.SlotServer(TPARAMS, TCFG, n_slots=2, max_len=32,
                               mesh=object())
        m = tmesh.ServingMesh({"tp": 2}, ["cpu"] * 2)
        with pytest.raises(ValueError, match="not bound"):
            serving.SlotServer(TPARAMS, TCFG, n_slots=2, max_len=32,
                               mesh=m)

    def test_the_placement_shape_and_local_geometry(self):
        place = serving.make_placement(_mesh({"tp": 2}), TCFG)
        assert place.shape == {"tp": 2}
        lc = place.local_cfg(TCFG)
        assert (lc.n_heads, lc.n_kv_heads, lc.d_ff) == (
            TCFG.n_heads // 2, TCFG.n_kv_heads // 2, TCFG.d_ff // 2)
        kv = place.place_kv(torch.zeros(2, 3, 4, TCFG.n_kv_heads, 8))
        assert kv.shape[3] == TCFG.n_kv_heads // 2


class TestCliMesh:
    def _build(self, *argv):
        from tpushare_torch.cli import serve as serve_mod
        return serve_mod.build_engine(serve_mod.build_parser().parse_args(
            ["--device", "cpu", *argv]))

    def test_bad_mesh_spec_exits_with_recipe(self):
        with pytest.raises(SystemExit, match="CPU testing recipe"):
            self._build("--mesh", "bogus=2")

    def test_dense_mesh_rejects_ep(self):
        with pytest.raises(SystemExit, match="expert parallelism"):
            self._build("--mesh", "tp=2,ep=2")

    def test_reshard_checkpoint_needs_mesh_flag(self):
        with pytest.raises(SystemExit, match="--mesh"):
            self._build("--reshard-checkpoint", "/tmp/nope")

    @pytest.mark.parametrize("argv", [
        ["--mesh", "tp=2", "--max-reshards", "7"],
        ["--mesh", "tp=2", "--reshard-checkpoint", "ckpt"],
        ["--process-view", "2"]])
    def test_degrade_replay_grow_flags_name_a10b(self, argv):
        with pytest.raises(NotImplementedError, match="A10b"):
            self._build(*argv)

    def test_a_multi_rank_mesh_needs_its_rendezvous(self):
        with pytest.raises(SystemExit, match="--dist-init"):
            self._build("--mesh", "tp=2")
        with pytest.raises(SystemExit, match="outside"):
            self._build("--mesh", "tp=1", "--rank", "3")

    def test_one_rank_mesh_serves_end_to_end(self):
        from tpushare_torch.cli import serve as serve_mod
        eng = self._build("--mesh", "tp=1", "--preset", "tiny",
                          "--n-blocks", "64", "--block-size", "4")
        req = serve_mod._Request([5, 9, 12, 3], 5, None)
        assert eng.submit(req)
        with eng._on_device():
            for _ in range(200):
                if req.done.is_set():
                    break
                eng._loop_once()
        assert req.done.is_set() and req.error is None
        st = eng.stats()
        assert st["mesh_shape"] == {} and st["num_devices"] == 1
        assert st["mesh_transport"] == "gloo"
        assert st["fetches_per_tick"] <= 1.0
        with pytest.raises(ValueError, match="A10b"):
            eng.chip_event(0, False)
        eng.stop()


class _FakeSrv:
    """A server whose calls record themselves; ``admit`` refuses when
    ``full``."""

    def __init__(self, full=False):
        self.calls, self.full = [], full

    def admit(self, prompt):
        self.calls.append(("admit", list(prompt)))
        if self.full:
            from tpushare_torch.models.paged import PoolExhausted
            raise PoolExhausted("no free slots")
        return len(self.calls)

    def step_async(self):
        self.calls.append(("step_async",))
        return serving.PendingStep(lambda inv: {0: 7, 1: 8})

    def evict(self, slot):
        self.calls.append(("evict", slot))


class _Wire:
    """A control group in process: rank 0's broadcasts land in a list;
    a follower reads a scripted one."""

    def __init__(self, script=()):
        self.sent, self.script = [], list(script)

    def __call__(self, mesh, msg=None):
        if mesh.rank == 0:
            self.sent.append(msg)
            return msg
        return self.script.pop(0)


class TestControlPlane:
    def test_rank_zero_broadcasts_each_call_before_it_runs(self,
                                                           monkeypatch):
        wire = _Wire()
        monkeypatch.setattr(control, "_bcast", wire)
        srv = _FakeSrv()
        sh = control.ShardedServer(srv, _mesh({"tp": 2}), heartbeat_s=60)
        assert sh.admit(np.array([1, 2])) == 1
        pend = sh.step_async()
        assert pend.slots == ()
        assert pend.finalize(frozenset({1})) == {0: 7, 1: 8}
        srv.full = True
        with pytest.raises(Exception, match="no free slots"):
            sh.admit([3])
        assert sh.calls is srv.calls            # reads pass through
        sh.stop()
        sh.stop()                                # once
        kinds = [m[0] for m in wire.sent]
        assert kinds == ["call", "call", "finalize", "call", "raised",
                         "stop"]
        assert wire.sent[0][2] == "admit"
        assert wire.sent[0][3][0].tolist() == [1, 2]
        assert wire.sent[2][1] == wire.sent[1][1]    # finalize's call
        assert wire.sent[4][1] == "PoolExhausted"
        with pytest.raises(RuntimeError, match="stopped"):
            sh.evict(0)

    def test_heartbeat_while_idle(self, monkeypatch):
        import time
        wire = _Wire()
        monkeypatch.setattr(control, "_bcast", wire)
        sh = control.ShardedServer(_FakeSrv(), _mesh({"tp": 2}),
                                   heartbeat_s=0.05)
        time.sleep(0.4)
        sh.stop()
        assert wire.sent.count(("ping",)) >= 2
        assert wire.sent[-1] == ("stop",)

    def _follow(self, monkeypatch, script, srv):
        monkeypatch.setattr(control, "_bcast", _Wire(script))
        return control.follow(srv, _mesh({"tp": 2}, rank=1))

    def test_follow_replays_in_order(self, monkeypatch):
        srv = _FakeSrv()
        n = self._follow(monkeypatch, [
            ("call", 1, "admit", ([1, 2],), {}), ("ping",),
            ("call", 2, "step_async", (), {}),
            ("finalize", 2, frozenset()), ("call", 3, "evict", (0,), {}),
            ("stop",)], srv)
        assert n == 4
        assert srv.calls == [("admit", [1, 2]), ("step_async",),
                             ("evict", 0)]

    def test_a_refusal_on_every_rank_is_replayed(self, monkeypatch):
        srv = _FakeSrv(full=True)
        n = self._follow(monkeypatch, [
            ("call", 1, "admit", ([1],), {}),
            ("raised", "PoolExhausted", "no free slots"), ("stop",)], srv)
        assert n == 1

    def test_a_follower_raising_alone_is_a_desync(self, monkeypatch):
        with pytest.raises(control.ControlDesync, match="rank 0 did not"):
            self._follow(monkeypatch, [
                ("call", 1, "admit", ([1],), {}), ("stop",)],
                _FakeSrv(full=True))

    def test_rank_zero_raising_alone_is_a_desync(self, monkeypatch):
        with pytest.raises(control.ControlDesync, match="did not"):
            self._follow(monkeypatch, [
                ("call", 1, "admit", ([1],), {}),
                ("raised", "PoolExhausted", "no free slots")], _FakeSrv())

    def test_unknown_calls_are_refused(self, monkeypatch):
        with pytest.raises(control.ControlDesync, match="unknown"):
            self._follow(monkeypatch, [("call", 1, "__del__", (), {})],
                         _FakeSrv())
        with pytest.raises(ValueError, match="rank 0"):
            control.follow(_FakeSrv(), _mesh({"tp": 2}, rank=0))


class TestTpSums:
    def test_tp_matmul_sums_f32_partials_and_rounds_once(self, monkeypatch):
        """A row-parallel product under tp: this rank's partial leaves the
        product in f32, the other rank's f32 partial joins it, and the sum
        rounds once to bf16; without a group it is ``x @ w``."""
        g = torch.Generator().manual_seed(0)
        x = torch.randn(2, 3, 16, generator=g).to(torch.bfloat16)
        w = torch.randn(16, 5, generator=g).to(torch.bfloat16)
        xa, xb, wa, wb = x[..., :8], x[..., 8:], w[:8], w[8:]
        other = xb.float() @ wb.float()
        monkeypatch.setattr(torch.distributed, "all_reduce",
                            lambda t, group=None: t.add_(
                                other.reshape(t.shape)))
        got = tt.tp_matmul(xa, wa, object())
        assert got.dtype == torch.bfloat16 and got.shape == (2, 3, 5)
        assert torch.equal(got, (xa.float() @ wa.float()
                                 + other).to(torch.bfloat16))
        assert torch.equal(tt.tp_matmul(x, w, None), x @ w)

    def test_drift_tool_runs_tiny_on_the_cpu(self, capsys):
        """tools/tp_drift.py at the tiny f32 size: both variants' rank
        threads agree with each other and with the one-card forward."""
        import json
        from tpushare_torch.tools import tp_drift
        assert tp_drift.main(["--device", "cpu", "--tiny", "--seeds",
                              "1"]) == 0
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        for name in ("f32_partials", "bf16_partials"):
            assert rec[name]["ranks_equal"]
            assert rec[name]["max"] < 1e-5
