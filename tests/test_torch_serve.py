"""The port's serving engine and HTTP surface (tpushare_torch.cli.serve)
against the JAX package's (tpushare.cli.serve), on the CPU.

Both engines serve the same bridged tiny weights (layer matrices x4, so
greedy streams change every tick) with the same options, over real HTTP
or driven tick by tick from the test thread (``_loop_once``) wherever a
verdict depends on which request the engine picks. Exact everywhere:
greedy token streams, ``/stats`` key sets and nulls, status codes,
preemption and quota verdicts, replays and journal recovery. Every HTTP
wait carries a timeout; nothing sleeps.
"""

import http.client
import json
import os
import signal
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from tpushare.cli import serve as jserve
from tpushare.models import transformer as jt
from tpushare.slo import quota as jquota

from tpushare_torch.cli import serve as tserve
from tpushare_torch.models import bridge
from tpushare_torch.slo import quota as tquota

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HTTP_TIMEOUT = 60
JCFG = jt.tiny(remat=False)
_JP = jt.init_params(jax.random.PRNGKey(0), JCFG)
JP = dict(_JP, layers={k: v * 4.0 if v.ndim == 3 else v
                       for k, v in _JP["layers"].items()})
TCFG = bridge.config_from_jax(JCFG)
TP = bridge.params_from_jax(JP, device="cpu")
KW = dict(n_slots=3, n_blocks=48, block_size=4, max_blocks_per_slot=12,
          idle_sleep_s=0.001, chaos_spec="")


# The grant keys a tenant's env carries: serving_mesh reads them, and a
# test elsewhere in the same worker may leave them set.
GRANT_KEYS = ("NVIDIA_VISIBLE_DEVICES", "TPU_VISIBLE_CHIPS",
              "TPU_VISIBLE_DEVICES")


@pytest.fixture(autouse=True)
def clean_grant_env():
    """No grant in the env, whatever ran before in this process; the
    whole env restored after."""
    saved = dict(os.environ)
    for k in list(os.environ):
        if k in GRANT_KEYS or k.startswith("ALIYUN_COM_TPU_MEM_"):
            os.environ.pop(k)
    yield
    os.environ.clear()
    os.environ.update(saved)


def _engine(which, **kw):
    opts = dict(KW, **kw)
    if which == "jax":
        # The oracle runs its serial tick: the JAX paged server hands
        # queued device work a host array the CPU backend may alias, so
        # its answers can depend on timing where host state changes
        # while a dispatch is in flight (ROADMAP C).
        opts.setdefault("overlap_tick", False)
        return jserve.ServeEngine(JP, JCFG, **opts)
    return tserve.ServeEngine(TP, TCFG, device="cpu", **opts)


def _prompts(n, seed, lo=5, hi=14):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, JCFG.vocab_size,
                                          int(rng.integers(lo, hi)))]
            for _ in range(n)]


def _request(mod, prompt, max_tokens, **kw):
    return mod._Request(list(prompt), max_tokens, None, **kw)


def _drive(engine, reqs, limit=400):
    """Submit and tick from the test thread until every request ends."""
    for r in reqs:
        assert engine.submit(r)
    ctx = getattr(engine, "_on_device", None)
    with (ctx() if ctx else _null()):
        for _ in range(limit):
            if all(r.done.is_set() for r in reqs):
                break
            engine._loop_once()
    assert all(r.done.is_set() for r in reqs), "engine stalled"
    return reqs


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _post(port, obj, idem=None, path="/v1/completions"):
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=HTTP_TIMEOUT)
    headers = {"Content-Type": "application/json"}
    if idem:
        headers["Idempotency-Key"] = idem
    try:
        conn.request("POST", path, json.dumps(obj).encode(), headers)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=HTTP_TIMEOUT)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _frames(body):
    """(events, raw token frames) of an SSE body."""
    events, frames = [], []
    for raw in body.split(b"\n\n"):
        raw = raw.strip()
        if not raw:
            continue
        for line in raw.splitlines():
            if line.startswith(b"data: "):
                ev = json.loads(line[len(b"data: "):])
                events.append(ev)
                if "token" in ev:
                    frames.append(raw + b"\n\n")
    return events, frames


def _stream(port, prompt, max_tokens):
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=HTTP_TIMEOUT)
    try:
        conn.request("POST", "/v1/completions", json.dumps(
            {"prompt": prompt, "max_tokens": max_tokens,
             "stream": True}).encode(), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        rid = resp.getheader("X-Request-Id")
        return rid, _frames(resp.read())
    finally:
        conn.close()


@pytest.fixture(scope="module")
def servers():
    """One JAX and one port engine behind HTTP, same weights and
    options (both overlapped ticks: the tests post one request at a
    time, so no admission lands beside a dispatch in flight)."""
    out = {}
    for which, mod in (("jax", jserve), ("torch", tserve)):
        eng = _engine(which, overlap_tick=True)
        httpd = mod.serve(eng, host="127.0.0.1", port=0,
                          timeout_s=HTTP_TIMEOUT)
        out[which] = (httpd.server_address[1], eng, httpd)
    yield {w: v[:2] for w, v in out.items()}
    for port, eng, httpd in out.values():
        _shutdown(httpd, eng)


def _shutdown(httpd, eng):
    httpd.shutdown()
    eng.stop()


class TestHttpParity:
    def test_greedy_streams_blocking_and_streaming(self, servers):
        prompts = _prompts(4, seed=1)
        got = {}
        for which, (port, _) in servers.items():
            outs = []
            for p in prompts:
                st, body = _post(port, {"prompt": p, "max_tokens": 7})
                assert st == 200
                outs.append(body["tokens"])
            for p in prompts[:2]:
                _, (events, frames) = _stream(port, p, 7)
                assert events[-1].get("done") is True
                outs.append([e["token"] for e in events if "token" in e])
            got[which] = outs
        assert got["torch"] == got["jax"]
        assert got["torch"][4:] == got["torch"][:2]
        assert len({tuple(o) for o in got["torch"]}) > 1

    def test_stats_key_set_and_nulls(self, servers):
        def shape(obj):
            if isinstance(obj, dict):
                return {k: shape(v) for k, v in obj.items()
                        if k != "tick_in_flight_ms"}
            return obj is None

        p = _prompts(1, seed=2)[0]
        shapes = {}
        for which, (port, _) in servers.items():
            assert _post(port, {"prompt": p, "max_tokens": 3})[0] == 200
            st, body = _get(port, "/stats")
            assert st == 200
            shapes[which] = shape(json.loads(body))
        assert shapes["torch"] == shapes["jax"]
        for key in ("mesh_shape", "degraded", "journal", "host_tier",
                    "tenants", "gang", "num_processes"):
            assert shapes["torch"][key] is True        # null, not zero
        stats = json.loads(_get(servers["torch"][0], "/stats")[1])
        assert stats["fetches_per_tick"] <= 1.0

    def test_status_codes(self, servers):
        V = JCFG.vocab_size
        bad = [({}, None), ({"prompt": "ids"}, None), ({"prompt": []}, None),
               ({"prompt": [1, V]}, None), ({"prompt": [-1]}, None),
               ({"prompt": [1], "max_tokens": 0}, None),
               ({"prompt": [1], "tier": "gold"}, None),
               ({"prompt": [1] * 60, "max_tokens": 2}, None),  # > slot
               ({"prompt": [1, 2], "adapter": True}, None),
               ({"prompt": [1, 2], "adapter": 0}, None)]   # no bank
        for which, (port, _) in servers.items():
            codes = [_post(port, body)[0] for body, _ in bad]
            assert codes == [400] * len(bad), (which, codes)
        for path in ("/nope", "/v1/completions/unknown-id"):
            codes = {w: _get(port, path)[0]
                     for w, (port, _) in servers.items()}
            assert codes == {"jax": 404, "torch": 404}
        assert _post(servers["torch"][0], {"device": 0, "rank": 0},
                     path="/mesh/host")[0] == 400

    def test_drain_and_undrain(self, servers):
        p = _prompts(1, seed=3)[0]
        for which, (port, _) in servers.items():
            assert _post(port, {}, path="/drain")[0] == 200
            assert _get(port, "/readyz")[0] == 503
            st, body = _post(port, {"prompt": p, "max_tokens": 2})
            assert st == 503 and "draining" in body["error"]
            assert _post(port, {}, path="/undrain")[0] == 200
            assert _get(port, "/readyz")[0] == 200
            assert _post(port, {"prompt": p, "max_tokens": 2})[0] == 200

    def test_idempotency_key(self, servers):
        p = _prompts(1, seed=4)[0]
        for which, (port, eng) in servers.items():
            key = f"key-{which}"
            s1, b1 = _post(port, {"prompt": p, "max_tokens": 4}, idem=key)
            s2, b2 = _post(port, {"prompt": p, "max_tokens": 4}, idem=key)
            assert s1 == s2 == 200 and b1 == b2
            s3, b3 = _post(port, {"prompt": p + [1], "max_tokens": 4},
                           idem=key)
            assert s3 == 409 and "Idempotency-Key" in b3["error"]
            assert eng.stats()["dedup_hits"] >= 1

    def test_resume_byte_identical(self, servers):
        port, _ = servers["torch"]
        rid, (_, frames) = _stream(port, _prompts(1, seed=5)[0], 6)
        assert rid and len(frames) == 6
        for cursor in (0, 3, 6):
            st, body = _get(port, f"/v1/completions/{rid}?from={cursor}")
            assert st == 200 and _frames(body)[1] == frames[cursor:]

    def test_stream_disconnect_frees_the_slot(self, servers):
        port, eng = servers["torch"]
        import socket
        sock = socket.create_connection(("127.0.0.1", port),
                                        timeout=HTTP_TIMEOUT)
        body = json.dumps({"prompt": _prompts(1, seed=6)[0],
                           "max_tokens": 4000, "stream": True}).encode()
        sock.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Type: application/json\r\nContent-Length: "
                     + str(len(body)).encode() + b"\r\n\r\n" + body)
        got = b""
        while got.count(b"data: ") < 3:
            got += sock.recv(4096)
        rid = [ln.split(b": ")[1] for ln in got.split(b"\r\n")
               if ln.lower().startswith(b"x-request-id")][0].decode()
        sock.close()
        req = eng.request_by_id(rid)
        assert req.done.wait(HTTP_TIMEOUT), "slot never freed"
        assert req.cancelled and len(req.tokens) < 4000


def test_full_queue_answers_429():
    """An engine whose queue is full (not started, so nothing drains
    it) answers 429 on both packages; the unserved request fails at
    stop."""
    from http.server import ThreadingHTTPServer
    for which, mod in (("jax", jserve), ("torch", tserve)):
        eng = _engine(which, max_queue=1)
        held = _request(mod, [1, 2, 3], 2)
        assert eng.submit(held)
        httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                    mod.make_handler(eng, HTTP_TIMEOUT))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            st, body = _post(httpd.server_address[1],
                             {"prompt": [4, 5], "max_tokens": 2})
            assert st == 429 and "queue full" in body["error"]
        finally:
            httpd.shutdown()
            eng.stop()
        assert held.done.is_set() and held.error == "server shutting down"


def test_inference_mode_on_the_engine_thread():
    """Grad mode is per thread: the engine thread enters inference mode
    itself (the test thread is outside it)."""
    eng = _engine("torch")
    seen = []
    real = eng.srv.step_async

    def spy(*a, **kw):
        seen.append(torch.is_inference_mode_enabled())
        return real(*a, **kw)

    eng.srv.step_async = spy
    httpd = tserve.serve(eng, port=0, timeout_s=HTTP_TIMEOUT)
    try:
        st, _ = _post(httpd.server_address[1],
                      {"prompt": [1, 2, 3], "max_tokens": 4})
    finally:
        _shutdown(httpd, eng)
    assert st == 200 and seen and all(seen)
    assert not torch.is_inference_mode_enabled()


@pytest.mark.parametrize("overlap", [True, False])
def test_overlap_and_serial_ticks_match_jax(overlap):
    """Tick-driven: the port's overlapped and serial ticks give the JAX
    engine's serial streams over whole admissions, and, through fused
    chunked admissions, each other's. (The JAX engine's fused ticks are
    no oracle: their host array can reach queued work, ROADMAP C.)"""
    prompts = _prompts(4, seed=7, lo=5, hi=26)

    def streams(which, mod, **kw):
        eng = _engine(which, **kw)
        reqs = _drive(eng, [_request(mod, p, 9) for p in prompts])
        assert all(r.error is None for r in reqs)
        chunked = eng.stats()["chunked_admits"]
        eng.stop()
        return [r.tokens for r in reqs], chunked

    want, _ = streams("jax", jserve)
    got, _ = streams("torch", tserve, overlap_tick=overlap)
    assert got == want
    fused = [streams("torch", tserve, overlap_tick=o, prefill_chunk=8)
             for o in (overlap, not overlap)]
    assert fused[0] == fused[1] and fused[0][1] >= 1


@pytest.mark.parametrize("sampled", [False, True])
def test_one_fetch_per_tick(sampled):
    from tests.test_torch_paged import count_fetches
    kw = {}
    if sampled:
        from tpushare_torch.models import quant
        kw = dict(temperature=0.8, top_k=40, top_p=0.9, gamma=2,
                  speculative_draft=(quant.quantize_params(TP, TCFG), TCFG),
                  draft_layers_hook=quant.dequant_hook(TCFG))
    for overlap in (True, False):
        eng = _engine("torch", overlap_tick=overlap, **kw)
        reqs = [_request(tserve, p, 40) for p in _prompts(2, seed=8)]
        for r in reqs:
            eng.submit(r)
        with eng._on_device():
            while len(eng._active) < 2:
                eng._loop_once()
            eng._loop_once()                    # fills the pipeline
            counts = []
            with count_fetches(counts):
                for _ in range(5):
                    counts.append(0)
                    eng._loop_once()
        assert counts == [1] * 5, (overlap, counts)
        assert eng.stats()["fetches_per_tick"] <= 1.0
        eng.stop()


def test_pool_exhaustion_preempts_one_victim():
    prompts = _prompts(2, seed=9, lo=10, hi=11)
    out = {}
    for which, mod in (("jax", jserve), ("torch", tserve)):
        eng = _engine(which, n_slots=2, n_blocks=12)
        reqs = _drive(eng, [_request(mod, p, 20) for p in prompts])
        out[which] = ([r.tokens for r in reqs],
                      eng.stats()["preempted"])
        assert all(len(r.tokens) == 20 for r in reqs)
        eng.stop()
    ref = _drive(_engine("torch"), [_request(tserve, p, 20)
                                    for p in prompts])
    assert out["torch"] == out["jax"]
    assert out["torch"][1] >= 1
    assert out["torch"][0] == [r.tokens for r in ref]


def test_quota_ceiling_parks_only_its_tenant():
    prompts = _prompts(3, seed=10, lo=10, hi=11)
    out = {}
    for which, mod, qmod in (("jax", jserve, jquota),
                             ("torch", tserve, tquota)):
        eng = _engine(which, tenant_quotas=qmod.parse_quota_spec("a=0:4"))
        reqs = [_request(mod, prompts[0], 6, tenant="a"),
                _request(mod, prompts[1], 6, tenant="a"),
                _request(mod, prompts[2], 6, tenant="b")]
        for r in reqs:
            eng.submit(r)
        ctx = getattr(eng, "_on_device", None)
        with (ctx() if ctx else _null()):
            eng._loop_once()
            first = (eng.stats()["quota_parked"], sorted(
                r.tenant for r in eng._active.values()))
            for _ in range(400):
                if all(r.done.is_set() for r in reqs):
                    break
                eng._loop_once()
        out[which] = (first, [r.tokens for r in reqs],
                      [r.error for r in reqs])
        eng.stop()
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == (1, ["a", "b"])


def _drive_all(eng, reqs, limit=600):
    with eng._on_device():
        for _ in range(limit):
            if all(r.done.is_set() for r in reqs):
                return
            eng._loop_once()


def test_nan_chaos_replays_token_exact_or_503():
    prompts = _prompts(3, seed=11)
    ref = _drive(_engine("torch"), [_request(tserve, p, 8)
                                    for p in prompts])
    eng = _engine("torch", chaos_spec="token_fetch:nan@p=0.3;seed=5",
                  max_replays=3)
    reqs = [_request(tserve, p, 8) for p in prompts]
    for r in reqs:
        eng.submit(r)
    _drive_all(eng, reqs)
    assert all(r.done.is_set() for r in reqs)
    assert eng.stats()["quarantines"] >= 1
    for r, want in zip(reqs, ref):
        if r.error is None:
            assert r.tokens == want.tokens
        else:
            assert r.status == 503 and "replays exhausted" in r.error


@pytest.mark.parametrize("recover_with", ["torch", "jax"])
def test_journal_recovery_finishes_streams_token_exact(tmp_path,
                                                       recover_with):
    prompts = _prompts(3, seed=12)
    ref = _drive(_engine("torch"), [_request(tserve, p, 10)
                                    for p in prompts])
    jdir = str(tmp_path / "wal")
    eng = _engine("torch", journal_dir=jdir)
    reqs = [_request(tserve, p, 10) for p in prompts]
    for r in reqs:
        eng.submit(r)
    with eng._on_device():
        for _ in range(5):                  # stop mid-stream
            eng._loop_once()
    assert any(0 < len(r.tokens) < 10 for r in reqs)
    eng._journal.close()                    # the "crash": no terminals
    mod = tserve if recover_with == "torch" else jserve
    eng2 = _engine(recover_with, journal_dir=jdir)
    assert eng2.stats()["recovered_requests"] == 3
    recovered = [eng2.request_by_id(r.request_id) for r in reqs]
    ctx = getattr(eng2, "_on_device", None)
    with (ctx() if ctx else _null()):
        for _ in range(400):
            if all(r.done.is_set() for r in recovered):
                break
            eng2._loop_once()
    assert [r.tokens for r in recovered] == [r.tokens for r in ref]
    assert isinstance(recovered[0], mod._Request)
    eng2.stop()


@pytest.mark.parametrize("argv", [
    ["--spec-horizon", "0"],
    ["--spec-horizon", "2"],
    ["--draft-preset", "int8-self", "--tick-token-budget", "3"],
    ["--tenant-quota", "acme=9:2"],
    ["--reshard-checkpoint", "/x"],
    ["--model-family", "moe", "--preset", "gemma_2b"],
    ["--model-family", "moe", "--int8-experts", "--draft-preset",
     "int8-self"],
    ["--model-family", "moe", "--n-blocks", "8"],
    ["--model-family", "moe", "--kv", "paged", "--max-len", "64"],
    ["--model-family", "moe", "--kv-quant"],
    ["--int8-experts"],
    ["--kv", "rows"],
    ["--max-len", "64"],
])
def test_build_engine_same_system_exit(argv):
    def run(mod, extra):
        args = mod.build_parser().parse_args(argv + extra)
        with pytest.raises(SystemExit) as ei:
            mod.build_engine(args)
        return str(ei.value)

    assert run(tserve, ["--device", "cpu"]) == \
        run(jserve, ["--platform", "cpu"])


def test_unported_flags_name_their_roadmap_item():
    """Every serve flag is ported: --mesh (its parity:
    tests/test_torch_mesh.py, tests/test_torch_sharded_serving.py), and
    since ROADMAP A10b a mesh's degrade-replay-grow budget and process
    views (tests/test_torch_elastic.py). A multi-rank mesh's budget is
    taken, its rendezvous still asked for; a process view without a
    mesh is read by neither daemon; the budget's default is the
    reference's."""
    args = tserve.build_parser().parse_args(
        ["--mesh", "tp=2", "--max-reshards", "3", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--dist-init"):
        tserve.build_engine(args)
    assert tserve.build_parser().parse_args([]).max_reshards == \
        jserve.build_parser().parse_args([]).max_reshards == 3
    eng = tserve.build_engine(tserve.build_parser().parse_args(
        ["--process-view", "2", "--device", "cpu", "--n-blocks", "32",
         "--block-size", "4"]))
    assert eng.stats()["num_processes"] is None
    eng.stop()
    assert not hasattr(tserve, "TODO_MESH")


def test_kv_endpoints_answer_501():
    """The endpoints answered 501 until the host tier was ported; now
    both engines answer alike without a tier: /kv/blocks omits unknown
    keys, /kv/migrate reports no tier, a malformed body is a 400."""
    answers = {}
    for which in ("torch", "jax"):
        eng = _engine(which)
        httpd = (tserve if which == "torch" else jserve).serve(
            eng, port=0, timeout_s=HTTP_TIMEOUT)
        port = httpd.server_address[1]
        try:
            st, body = _get(port, "/kv/blocks?keys=ab")
            got = [(st, json.loads(body))]
            got.append(_post(port, {"source": "http://x", "keys": ["ab"]},
                             path="/kv/migrate"))
            got.append(_post(port, {"source": "http://x", "keys": []},
                             path="/kv/migrate")[0])
            answers[which] = got
        finally:
            _shutdown(httpd, eng)
    assert answers["torch"] == answers["jax"]
    assert answers["torch"][0] == (200, {"block_size": 4, "blocks": {}})
    assert answers["torch"][1] == (200, {"migrated": 0,
                                         "decision": "no_tier"})
    assert answers["torch"][2] == 400


def test_engine_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.ServeEngine(TP, TCFG, **KW)


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_lost_device_ends_red_and_bounded(monkeypatch):
    """A sticky CUDA error fails every replay: the engine thread hands
    it to the supervisor, whose restart budget turns /healthz red."""
    eng = _engine("torch", max_engine_restarts=2, restart_backoff_s=0.001)
    monkeypatch.setattr(eng, "_device_lost", lambda e: True)

    def broken(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access")

    eng.srv.step_async = broken
    eng.srv.step = broken
    req = _request(tserve, [1, 2, 3], 5)
    eng.start()
    eng.submit(req)
    assert req.done.wait(HTTP_TIMEOUT)
    eng._supervisor.join(HTTP_TIMEOUT)
    assert not eng.healthy() and eng.state() == "dead"
    assert eng.stats()["engine_restarts"] == 2 and req.status == 503
    eng.stop()


def test_cli_starts_on_cpu_and_names_the_missing_card():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpushare_torch.cli.serve", "--device",
         "cpu", "--preset", "tiny", "--port", "0"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = []
        reader = threading.Thread(
            target=lambda: line.append(proc.stdout.readline()))
        reader.start()
        reader.join(HTTP_TIMEOUT)
        assert line and line[0].startswith("tpushare-torch-serve on")
        port = int(line[0].split(":")[1].split()[0])
        assert _get(port, "/healthz")[0] == 200
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(HTTP_TIMEOUT) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, "-m", "tpushare_torch.cli.serve", "--preset",
         "tiny", "--port", "0"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=HTTP_TIMEOUT)
    assert out.returncode != 0 and "CUDA" in out.stderr


@pytest.mark.parametrize("kv", ["rows", "paged"])
def test_moe_engine_matches_jax(kv):
    """The MoE family behind both engines (dense rows via the adapter,
    or the paged pool via moe.paged_forward), tick-driven on the same
    bridged tiny weights: equal greedy streams, null pool keys for
    rows."""
    from tpushare.models import moe as jm
    jcfg = jm.tiny(remat=False)
    jp = jm.init_params(jax.random.PRNGKey(1), jcfg)
    jp = dict(jp, layers={k: v * 4.0 if v.ndim >= 3 else v
                          for k, v in jp["layers"].items()})
    tcfg = bridge.moe_config_from_jax(jcfg)
    tp = bridge.params_from_jax(jp, device="cpu")
    opts = dict(n_slots=2, model_family="moe", kv=kv, max_len=64,
                idle_sleep_s=0.001, chaos_spec="")
    if kv == "paged":
        opts.update(n_blocks=32, block_size=4)
    rng = np.random.default_rng(13)
    prompts = [[int(t) for t in rng.integers(0, jcfg.vocab_size, n)]
               for n in (6, 11, 9)]
    streams = {}
    for which, mod in (("jax", jserve), ("torch", tserve)):
        eng = (jserve.ServeEngine(jp, jcfg, **opts) if which == "jax"
               else tserve.ServeEngine(tp, tcfg, device="cpu", **opts))
        reqs = _drive(eng, [_request(mod, p, 6) for p in prompts])
        streams[which] = [r.tokens for r in reqs]
        st = eng.stats()
        assert (st["free_blocks"] is None) == (kv == "rows")
        eng.stop()
    assert streams["torch"] == streams["jax"]


def test_moe_int8_experts_engine_serves():
    """--model-family moe --int8-experts: the fused int8 expert hook
    (the q8 kernel's plain version here) and the dequant hook each serve
    a full stream of in-vocabulary tokens."""
    outs = {}
    for hook in ("fused", "dequant"):
        args = tserve.build_parser().parse_args(
            ["--device", "cpu", "--model-family", "moe", "--int8-experts",
             "--int8-expert-hook", hook, "--n-slots", "2", "--max-len",
             "64"])
        eng = tserve.build_engine(args)
        reqs = _drive(eng, [_request(tserve, [1, 2, 3, 4, 5], 5)])
        outs[hook] = reqs[0].tokens
        assert reqs[0].error is None
        assert all(0 <= t < eng.srv.cfg.vocab_size for t in reqs[0].tokens)
        eng.stop()
    assert len(outs["fused"]) == len(outs["dequant"]) == 5


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_stop_joins_every_thread_it_started():
    """stop() leaves no thread of the engine running: the supervisor
    and the engine thread (here after a lethal error made the
    supervisor start a second one) are joined before it returns."""
    eng = _engine("torch", max_engine_restarts=2, restart_backoff_s=0.01)
    real, died = eng._loop_once, threading.Event()

    def once(gen=None):
        if not died.is_set():
            died.set()
            raise SystemExit("lethal")      # kills engine-0 outright
        return real(gen)

    eng._loop_once = once
    httpd = tserve.serve(eng, port=0, timeout_s=HTTP_TIMEOUT)
    try:
        st, body = _post(httpd.server_address[1],
                         {"prompt": [1, 2, 3], "max_tokens": 4})
        assert st == 200 and len(body["tokens"]) == 4
        assert eng.stats()["engine_restarts"] == 1
        started = [eng._supervisor, eng._thread]
        assert eng.live_threads() == ["engine-supervisor", "engine-1"]
    finally:
        _shutdown(httpd, eng)
    assert eng.live_threads() == []
    assert not any(t.is_alive() for t in started)


def test_stop_names_a_wedged_engine_thread(capsys, monkeypatch):
    """A tick that does not return within stop()'s bound: stop() says
    so (stderr and /stats last_error) and live_threads() names it,
    instead of returning as if the engine were down."""
    eng = _engine("torch")
    release, entered = threading.Event(), threading.Event()

    def wedged(gen=None):
        entered.set()
        release.wait(HTTP_TIMEOUT)

    eng._loop_once = wedged
    eng.start()
    assert entered.wait(HTTP_TIMEOUT)
    monkeypatch.setattr(tserve, "STOP_JOIN_S", 0.2)
    eng.stop()
    try:
        assert "engine-0" in eng.live_threads()
        assert "wedged" in eng.stats()["last_error"]
        assert "wedged" in capsys.readouterr().err
    finally:
        release.set()
        eng._thread.join(HTTP_TIMEOUT)
        eng._supervisor.join(HTTP_TIMEOUT)
    assert eng.live_threads() == []
