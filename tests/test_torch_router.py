"""The port's router (tpushare_torch.router: copies of tpushare/router's
core and daemon, held equal in code by tests/test_torch_slo_copies.py)
against the JAX package's Router, on the same fake replica states, and
the port's two smokes end to end on the CPU.

- Behaviour over seeded op sequences (hypothesis): replica stats
  (queue, slots, pool, host tier, wedge, degraded meshes), prefix
  gossip, breaker failures, score updates; every route choice, the
  least-loaded metric, plan_migration, shed waits, the scale advisory
  and /stats agree.
- Scenarios after tests/test_router.py and tests/test_kv_offload.py:
  affinity, the breaker's threshold and backoff, scoring, shedding by
  tier, migration planning and its chaos point.
- ``python -m tpushare_torch.router.smoke`` and ``.offload_smoke`` with
  ``--device cpu --preset tiny`` exit 0: the storm is token-exact to a
  single port engine, migrations land and promote.
"""

import time
import types

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tpushare.router import core as jcore
from tpushare.router import daemon as jdaemon

from tpushare_torch.router import core as tcore
from tpushare_torch.router import daemon as tdaemon
from tpushare_torch.router import offload_smoke, smoke

URLS = ["http://a:1", "http://b:2", "http://c:3"]
KEYS = ["k%d" % i for i in range(6)]
SETTINGS = settings(max_examples=60, deadline=None, derandomize=True,
                    suppress_health_check=[HealthCheck.too_slow])


def _pair(**kw):
    kw.setdefault("poll_interval_s", 9999)
    kw.setdefault("shed_wait_s", 0.0)
    return jcore.Router(URLS, **kw), tcore.Router(URLS, **kw)


def _idx(router, rep):
    return None if rep is None else router.replicas.index(rep)


_stats = st.fixed_dictionaries({
    "n_slots": st.integers(1, 8),
    "queue_depth": st.integers(0, 6),
    "active_slots": st.integers(0, 8),
    "pool_free_frac": st.one_of(st.none(), st.floats(0, 1)),
    "tick_in_flight_ms": st.one_of(st.none(), st.floats(0, 2000)),
    "host_tier": st.one_of(st.none(), st.fixed_dictionaries({
        "budget_bytes": st.integers(1, 1000),
        "bytes_resident": st.integers(0, 1000)})),
    "num_devices": st.one_of(st.none(), st.integers(1, 4)),
    "num_devices_configured": st.one_of(st.none(), st.just(4)),
    "quarantines": st.integers(0, 3),
    "deadline_breaches": st.integers(0, 3),
    "engine_restarts": st.integers(0, 2),
})

_ops = st.lists(st.one_of(
    st.tuples(st.just("stats"), st.integers(0, 2), _stats),
    st.tuples(st.just("gossip"), st.integers(0, 2), st.integers(0, 6),
              st.sampled_from([8, 16, None])),
    st.tuples(st.just("fail"), st.integers(0, 2)),
    st.tuples(st.just("ready"), st.integers(0, 2), st.booleans()),
    st.tuples(st.just("inflight"), st.integers(0, 2), st.integers(0, 3)),
    st.tuples(st.just("route"), st.integers(0, 6)),
    st.tuples(st.just("plan"), st.integers(0, 6), st.integers(0, 2)),
    st.tuples(st.just("shed"), st.sampled_from(
        ["interactive", "standard", "batch"])),
), min_size=1, max_size=30)


@SETTINGS
@given(_ops, st.sampled_from(["affinity", "least_loaded"]),
       st.integers(0, 3))
def test_router_same_decisions_on_the_same_replica_states(ops, policy,
                                                          min_blocks):
    # Both routers read one stepped clock (their modules' ``time`` only).
    now = [1000.0]
    clock = types.SimpleNamespace(monotonic=lambda: now[0],
                                  sleep=time.sleep)
    jcore.time = tcore.time = clock
    try:
        routers = _pair(policy=policy, breaker_threshold=2,
                        migrate_min_blocks=min_blocks)
        for op in ops:
            outs = []
            for r in routers:
                out = None
                if op[0] == "stats":
                    rep = r.replicas[op[1]]
                    with r._lock:
                        rep.stats = dict(op[2])
                        r._rescore(rep, rep.stats)
                elif op[0] == "gossip":
                    rep = r.replicas[op[1]]
                    rep.prefix_keys = set(KEYS[:op[2]])
                    rep.block_size = op[3]
                elif op[0] == "fail":
                    with r._lock:
                        r._note(r.replicas[op[1]], "injected")
                elif op[0] == "ready":
                    r.replicas[op[1]].ready = op[2]
                elif op[0] == "inflight":
                    r.replicas[op[1]].inflight = op[2]
                elif op[0] == "route":
                    try:
                        out = _idx(r, r.route(KEYS[:op[1]]))
                    except Exception as e:      # noqa: BLE001
                        out = type(e).__name__
                elif op[0] == "plan":
                    plan = r.plan_migration(KEYS[:op[1]],
                                            r.replicas[op[2]])
                    out = (None if plan is None
                           else (_idx(r, plan[0]), plan[1]))
                else:
                    out = r.shed_wait_s(op[1])
                outs.append((out, [r._load(x) for x in r.replicas],
                             [x.snapshot() for x in r.replicas],
                             r.stats(), r.scale_advice()))
            now[0] += 0.25
            assert outs[0] == outs[1]
    finally:
        jcore.time = tcore.time = time


class TestScenarios:
    def _routers(self, **kw):
        kw.setdefault("migrate_min_blocks", 2)
        out = []
        for core in (jcore, tcore):
            r = core.Router(URLS[:2], poll_interval_s=9999, **kw)
            out.append(r)
        return out

    def test_affinity_picks_the_chain_holder_and_stops_at_a_miss(self):
        got = []
        for r in self._routers():
            a, b = r.replicas
            a.prefix_keys = {"k0", "k2"}
            b.prefix_keys = {"k0", "k1"}
            got.append((_idx(r, r.route(["k0", "k1", "k2"])),
                        _idx(r, r.route(["k3"])), r.stats()))
        assert got[0] == got[1] and got[1][0] == 1

    def test_breaker_threshold_backoff_and_routability(self):
        got = []
        for r in self._routers(breaker_threshold=2, breaker_backoff_s=0.5):
            a, _ = r.replicas
            with r._lock:
                r._note(a, "x")
                first = a.breaker
                r._note(a, "x")
            got.append((first, a.breaker, a.backoff_s,
                        _idx(r, r.route([])), r.stats()["breaker_opens"]))
        assert got[0][:2] == got[1][:2] == (tcore.CLOSED, tcore.OPEN)
        assert got[0][2:] == got[1][2:] and got[1][3] == 1

    def test_scoring_sinks_on_climbing_counters(self):
        got = []
        for r in self._routers():
            a, _ = r.replicas
            with r._lock:
                r._rescore(a, {"quarantines": 0})
                r._rescore(a, {"quarantines": 2})
            got.append(a.score)
        assert got[0] == got[1] == 0.25

    def test_shed_order_by_tier(self):
        got = []
        for r in self._routers(shed_wait_s=0.0):
            for rep in r.replicas:
                rep.ready = False
            for tier in ("batch", "standard"):
                with pytest.raises(Exception) as ei:
                    r.route_or_shed([], tier=tier)
                assert type(ei.value).__name__ == "NoReplicaAvailable"
            got.append(r.stats()["shed_by_tier"])
        assert got[0] == got[1] and got[1]["batch"] == 1

    @pytest.mark.parametrize("case", ["longer", "threshold", "disabled",
                                      "no_gossip"])
    def test_plan_migration(self, case):
        got = []
        for r in self._routers(
                migrate_min_blocks=0 if case == "disabled" else 2):
            a, b = r.replicas
            if case != "no_gossip":
                a.block_size = b.block_size = 8
            if case == "threshold":
                a.prefix_keys = {"k0", "k1"}
            b.prefix_keys = {"k0", "k1", "k2"}
            plan = r.plan_migration(["k0", "k1", "k2", "k3"], a)
            got.append(None if plan is None
                       else (_idx(r, plan[0]), plan[1]))
        assert got[0] == got[1]
        assert (got[1] is not None) == (case == "longer")

    def test_block_fetch_chaos_counts_failed_never_blocks(self):
        got = []
        for r in self._routers(chaos_spec="block_fetch:raise@p=1.0;seed=1"):
            a, b = r.replicas
            a.block_size = b.block_size = 8
            b.prefix_keys = {"k0", "k1"}
            r._maybe_migrate(a, ["k0", "k1"], None)
            st_ = r.stats()
            got.append((st_["migrations_instructed"],
                        st_["migrations_failed"], st_["migrated_blocks"]))
        assert got[0] == got[1] == (1, 1, 0)

    def test_daemon_argv_builds_the_same_router(self):
        argv = ["--replicas", ",".join(URLS), "--policy", "least_loaded",
                "--migrate-min-blocks", "3", "--retry-budget", "1"]
        rs = [m.build_router(m.build_arg_parser().parse_args(argv))
              for m in (jdaemon, tdaemon)]
        for attr in ("policy", "_migrate_min_blocks", "_retry_budget",
                     "_breaker_threshold", "default_tier"):
            assert getattr(rs[0], attr) == getattr(rs[1], attr)
        assert [x.url for x in rs[1].replicas] == URLS


@pytest.mark.parametrize("module", [smoke, offload_smoke],
                         ids=["smoke", "offload_smoke"])
def test_port_smoke_exits_zero_on_the_cpu(module, capsys):
    assert module.main(["--device", "cpu", "--preset", "tiny"]) == 0
    assert '"ok": true' in capsys.readouterr().out
