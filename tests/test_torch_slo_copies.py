"""The port's copies of the JAX package's host-only modules (``slo/``,
``durable/``, ``chaos/``, ``router/``, ``utils/``, ``utils/data.py``
among them), held equal to
their originals (the rule that keeps ``tpushare_torch`` free of any
``tpushare`` import, as ``router/chainkeys.py`` is held today).

- Code: every copied module's AST equals its original's once docstrings
  are dropped and ``tpushare_torch.`` reads ``tpushare.``.
- Behaviour, over seeded random op sequences (hypothesis): ``KvQuota``
  verdicts, charges and snapshots; ``TickScheduler`` picks, admission
  choices and alternation verdicts; ``TierStats`` snapshots.
- The journal: the same events give byte-identical WAL segments, and
  each package's ``scan`` reads the other's files to the same requests.
- The chaos injector: the same parsed spec and the same fire sequence
  for one seed.
- ``read_tenant_env``, ``kv_quota_env`` and ``gap_percentiles``: the
  same outputs for the same env and samples.
"""

import ast
import dataclasses
import os

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tpushare.chaos import injector as jchaos
from tpushare.durable import journal as jjournal
from tpushare.slo import quota as jquota
from tpushare.slo import sched as jsched
from tpushare.slo import stats as jstats
from tpushare.utils import profiling as jprof
from tpushare.utils import tenant as jtenant

from tpushare_torch.chaos import injector as tchaos
from tpushare_torch.durable import journal as tjournal
from tpushare_torch.slo import quota as tquota
from tpushare_torch.slo import sched as tsched
from tpushare_torch.slo import stats as tstats
from tpushare_torch.utils import profiling as tprof
from tpushare_torch.utils import tenant as ttenant

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIES = ["slo/__init__.py", "slo/tiers.py", "slo/stats.py", "slo/quota.py",
          "slo/sched.py", "durable/__init__.py", "durable/journal.py",
          "chaos/__init__.py", "chaos/injector.py", "utils/ownership.py",
          "utils/atomicio.py", "utils/data.py", "router/__init__.py",
          "router/chainkeys.py",
          "router/core.py", "router/daemon.py"]
TENANTS = ["acme", "bg", "default", "other"]
QUOTA_TEXT = "acme=4:10,bg=0:6,default=2:"
SETTINGS = settings(max_examples=40, deadline=None, derandomize=True,
                    suppress_health_check=[HealthCheck.too_slow])


def _code(path, rename=False):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    text = ast.dump(tree)
    if not rename:
        return text
    # The port's console scripts are named tpushare-torch-*.
    return text.replace("tpushare_torch", "tpushare").replace(
        "tpushare-torch-", "tpushare-")


@pytest.mark.parametrize("rel", COPIES)
def test_copy_code_equals_original(rel):
    assert _code(os.path.join(ROOT, "tpushare_torch", rel), rename=True) \
        == _code(os.path.join(ROOT, "tpushare", rel))


_quota_ops = st.lists(st.tuples(
    st.sampled_from(["charge", "refund", "verdict", "attainable",
                     "headroom", "host_charge", "host_refund"]),
    st.sampled_from(TENANTS), st.integers(0, 12), st.integers(0, 40)),
    min_size=1, max_size=40)


@SETTINGS
@given(_quota_ops)
def test_kv_quota_same_verdicts_and_snapshots(ops):
    qs = [m.KvQuota(m.parse_quota_spec(QUOTA_TEXT))
          for m in (jquota, tquota)]
    for op, tenant, n, total in ops:
        outs = []
        for q in qs:
            if op == "charge":
                q.charge(tenant, n)
                out = None
            elif op == "refund":
                q.refund(tenant, n)
                out = None
            elif op == "verdict":
                out = q.admit_verdict(tenant, n, total)
            elif op == "attainable":
                out = q.attainable_blocks(tenant, total)
            elif op == "headroom":
                out = (q.reserved_headroom(tenant),
                       q.reserved_headroom(tenant, {tenant: n}))
            elif op == "host_charge":
                q.host_charge(tenant, n * 1024)
                out = q.host_over(tenant)
            else:
                q.host_refund(tenant, n * 1024)
                out = q.host_over(tenant)
            outs.append((out, q.snapshot(), q.ledger_view(),
                         q.over_floor(tenant), q.over_ceiling(tenant)))
        assert outs[0] == outs[1]


@dataclasses.dataclass(eq=False)
class _Req:
    tier: str
    seq: int
    t_submit: float
    tokens: list


_sched_ops = st.lists(st.tuples(
    st.sampled_from(["push", "push_front", "pop", "peek", "admit",
                     "peek_admission", "alternation", "victim"]),
    st.sampled_from(["interactive", "standard", "batch"]),
    st.booleans(), st.integers(0, 5)), min_size=1, max_size=60)


@SETTINGS
@given(_sched_ops)
def test_tick_scheduler_same_picks(ops):
    """The same ops, on request twins, give the same picks (by seq) on
    both schedulers; deadline risk is fixed by the injected clock."""
    scheds = [m.TickScheduler(now_fn=lambda: 1000.0)
              for m in (jsched, tsched)]
    admitting = [{}, {}]
    active = [{}, {}]
    seq = 0

    def key(r):
        return None if r is None else r.seq

    for op, tier, late, slot in ops:
        seq += 1
        outs = []
        for i, (s, m) in enumerate(zip(scheds, (jsched, tsched))):
            # late: submitted 1000 s ago (at risk where a deadline
            # exists); else just now.
            req = _Req(tier, seq, 0.0 if late else 1000.0, [])
            if op == "push":
                s.push(req)
                out = s.backlog_by_tier()
            elif op == "push_front":
                s.push_front(req)
                out = s.backlog_by_tier()
            elif op == "pop":
                r = s.pop()
                out = key(r)
                if r is not None:
                    admitting[i][slot] = r
                    active[i][slot + 8] = r
            elif op == "peek":
                out = key(s.peek())
            elif op == "admit":
                out = s.pick_admission(admitting[i])
            elif op == "peek_admission":
                c = s.peek_admission(admitting[i])
                out = None if c is None else (c.slot, c.tier, c.risk)
            elif op == "alternation":
                out = s.alternation(req, active[i])
            else:
                out = m.choose_victim(active[i], below_rank=slot % 3)
            outs.append((out, s.backlog(), s.at_risk(req)))
        assert outs[0] == outs[1]
    assert [key(r) for r in scheds[0].drain()] == \
        [key(r) for r in scheds[1].drain()]


@SETTINGS
@given(st.lists(st.tuples(
    st.sampled_from(["interactive", "standard", "batch"]),
    st.sampled_from(["admitted", "preempted", "tokens", "ttft", "done"]),
    st.floats(0, 5000, allow_nan=False), st.integers(1, 40)),
    max_size=80))
def test_tier_stats_same_snapshots(events):
    ts = [jstats.TierStats(), tstats.TierStats()]
    for tier, what, ms, n in events:
        for s in ts:
            if what == "ttft":
                s.record_first_token(tier, ms)
            elif what == "done":
                s.record_completion(tier, n, ms)
            else:
                s.bump(tier, what, n)
        assert ts[0].snapshot() == ts[1].snapshot()


def _journal_events(j):
    j.append({"k": "ACCEPT", "id": "a", "key": "k1",
              "ph": jjournal.prompt_hash([1, 2, 3]), "prompt": [1, 2, 3],
              "tier": "standard", "tenant": "default", "mt": 4,
              "eos": None, "adapter": -1})
    j.append({"k": "TOKENS", "id": "a", "s": 0, "t": [7, 8]})
    j.append({"k": "ACCEPT", "id": "b", "key": None,
              "ph": jjournal.prompt_hash([5]), "prompt": [5],
              "tier": "batch", "tenant": "bg", "mt": 2, "eos": 9,
              "adapter": -1})
    j.tick_flush()
    j.append({"k": "TOKENS", "id": "a", "s": 2, "t": [9, 10]})
    j.append({"k": "DONE", "id": "a", "n": 4})
    j.append({"k": "TOKENS", "id": "b", "s": 0, "t": [3]})
    j.tick_flush()
    j.close()


def _segments(path):
    return {n: open(os.path.join(path, n), "rb").read()
            for n in sorted(os.listdir(path))}


def _recovered(requests):
    return {rid: dataclasses.asdict(r) for rid, r in requests.items()}


def test_journal_bytes_identical_and_cross_readable(tmp_path):
    dirs = {}
    for name, m in (("jax", jjournal), ("torch", tjournal)):
        d = str(tmp_path / name)
        _journal_events(m.Journal(d, fsync="off"))
        dirs[name] = d
    assert _segments(dirs["jax"]) == _segments(dirs["torch"])
    assert tjournal.prompt_hash([4, 5]) == jjournal.prompt_hash([4, 5])
    want = _recovered(jjournal.scan(dirs["jax"]))
    assert _recovered(tjournal.scan(dirs["jax"])) == want
    assert _recovered(jjournal.scan(dirs["torch"])) == want
    assert want["a"]["status"] == "done" and want["b"]["status"] == "open"


@pytest.mark.parametrize("spec", [
    "forward:raise@p=0.3;token_fetch:nan@p=0.5;seed=7",
    "admit:raise@p=0.5;kill:raise@p=0.1;seed=11",
    "engine.tick.forward:raise@p=1.0;journal_write:raise@p=0.2;"
    "proxy:raise@p=0.4;seed=3"])
def test_chaos_same_spec_and_fire_sequence(spec):
    def run(m):
        faults, seed = m.parse_spec(spec)
        inj = m.Injector.from_spec(spec)
        points = {f.point for f in faults}
        seq = []
        for i in range(40):
            for name in sorted(points):
                try:
                    v = inj.point(name)({0: 5, 1: [3, 4]})
                    seq.append((name, "ok", repr(v)))
                except m.InjectedFault as e:
                    seq.append((name, type(e).__name__, str(e)))
        return ([dataclasses.astuple(f) for f in faults], seed,
                inj.spec_summary(), inj.fired_snapshot(), seq)

    assert run(tchaos) == run(jchaos)


@pytest.mark.parametrize("env", [
    {},
    {"TPU_VISIBLE_CHIPS": "2,0", "TPUSHARE_HBM_LIMIT_BYTES": "1024",
     "ALIYUN_COM_TPU_MEM_CONTAINER": "3", "ALIYUN_COM_TPU_MEM_DEV": "8"},
    {"TPUSHARE_KV_BLOCK_RESERVE": "4", "TPUSHARE_KV_BLOCK_LIMIT": "9"},
    {"TPUSHARE_KV_BLOCK_LIMIT": "7", "CTPU_DISABLE": "true"},
    {"TPUSHARE_KV_BLOCK_RESERVE": "9", "TPUSHARE_KV_BLOCK_LIMIT": "2"},
    {"TPU_VISIBLE_DEVICES": "no-tpu-has-3GiB-to-run"},
])
def test_tenant_env_same_outputs(env, monkeypatch):
    for k in ("TPU_VISIBLE_CHIPS", "TPU_VISIBLE_DEVICES",
              "TPUSHARE_HBM_LIMIT_BYTES", "ALIYUN_COM_TPU_MEM_POD",
              "ALIYUN_COM_TPU_MEM_CONTAINER", "ALIYUN_COM_TPU_MEM_DEV",
              "CTPU_DISABLE", "TPUSHARE_KV_BLOCK_RESERVE",
              "TPUSHARE_KV_BLOCK_LIMIT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    def run(m, fn):
        try:
            out = getattr(m, fn)()
        except m.AllocationError as e:
            return ("AllocationError", str(e))
        if isinstance(out, dict):
            return {t: dataclasses.asdict(s) for t, s in out.items()}
        return None if out is None else dataclasses.asdict(out)

    for fn in ("read_tenant_env", "kv_quota_env"):
        assert run(ttenant, fn) == run(jtenant, fn)


@SETTINGS
@given(st.lists(st.floats(0, 1e4, allow_nan=False), max_size=600))
def test_gap_percentiles_same(samples):
    assert tprof.gap_percentiles(samples) == jprof.gap_percentiles(samples)
    assert tprof.HOST_GAP_CAP == jprof.HOST_GAP_CAP
