"""Host-kill smoke for multi-process serving (``python -m
tpushare_torch.parallel.multihost_smoke``). Counterpart of
``tpushare/parallel/multihost_smoke.py``: the same exit rule and JSON
keys.

The CI gate for the failure ladder's last rung. A tp=2 engine of two
real rank processes (``cli/serve.py --mesh tp=2 --process-view 2``:
two hosts of one rank each, rank 0 running the gang liaison) serves a
wave of requests; mid-wave rank 1's process is SIGKILLed. The liaison
detects the silence, the engine reshards to tp=1 on rank 0 and replays
every in-flight request; rank 1 is restarted, stands by, heartbeats
again, and the engine grows back to tp=2 at an idle tick; a second wave
is served on the regrown mesh. Exit 0 iff

  * ZERO lost requests — every answer of both waves is token-exact vs
    the single-process unsharded oracle (clean 429 rejections at
    submit are not losses), AND
  * at least one reshard ACROSS a process boundary was observed
    (host_losses >= 1 and reshards >= 1), AND
  * the mesh grew back to full after the host rejoined, and the
    restarted rank's call digest of the regrown generation equals
    rank 0's.

The liaison's timeout-detection path is checked first as a pure-TCP
check (sever -> silence ages out -> lost -> reconnect -> rejoined).
``--scenario chip`` drives the same shrink with ``POST /mesh/chip``
(rank 1's process stays alive and stands by) instead of a kill.
``run_elastic`` drives a scenario; ``tools/multichip.py`` runs it at
Llama-3-8B's width on the card.

Prints one JSON summary line; nonzero exit on any violation::

    python -m tpushare_torch.parallel.multihost_smoke --device cpu
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional


def _liaison_check() -> dict:
    """Sever -> timeout-detected loss -> reconnect -> rejoin, over a
    real socket pair. Pure stdlib."""
    from tpushare_torch.parallel.gang import GangFollower, GangLeader
    leader = GangLeader(2, heartbeat_timeout_s=0.3)
    follower = GangFollower(f"127.0.0.1:{leader.port}", 1,
                            interval_s=0.05, fetches_fn=lambda: 0)
    try:
        deadline = time.monotonic() + 5.0
        while (leader.seen_ranks() != [1]
               and time.monotonic() < deadline):
            time.sleep(0.02)
        if leader.seen_ranks() != [1]:
            return {"ok": False, "why": "follower never heartbeat"}
        leader.sever(1)
        lost = rejoined = False
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            ev = leader.poll()
            lost = lost or 1 in ev["lost"]
            rejoined = rejoined or (lost and 1 in ev["rejoined"])
            if rejoined:
                break
            time.sleep(0.05)
        return {"ok": lost and rejoined, "lost": lost,
                "rejoined": rejoined}
    finally:
        follower.stop()
        leader.close()


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _http(port: int, path: str, body=None, timeout: float = 600.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _wave(port: int, prompts, max_tokens: int, timeout: float):
    """Post every prompt at once; (answers, statuses) in prompt order."""
    out: List[Optional[list]] = [None] * len(prompts)
    codes: List[Optional[int]] = [None] * len(prompts)

    def post(i):
        try:
            codes[i], body = _http(port, "/v1/completions",
                                   {"prompt": [int(t) for t in prompts[i]],
                                    "max_tokens": max_tokens}, timeout)
            out[i] = body.get("tokens")
        except OSError as e:
            codes[i], out[i] = None, None
            print(f"wave: prompt {i}: {e}", file=sys.stderr, flush=True)
    threads = [threading.Thread(target=post, args=(i,), daemon=True)
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    return threads, out, codes


def _wait(pred, timeout: float, every: float = 0.05) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(every)
    return False


def run_elastic(engine_argv: List[str], prompts, max_tokens: int, *,
                scenario: str, log_dir: str, env=None,
                timeout: float = 600.0,
                n_wave2: Optional[int] = None) -> dict:
    """Drive a two-rank ``--mesh tp=2`` engine (``engine_argv``: the
    model and pool flags, ``--device`` included) through one shrink
    and one grow-back: wave 1 over HTTP, mid-wave either ``POST
    /mesh/chip`` marking rank 1's card unhealthy (``scenario="chip"``)
    or a SIGKILL of rank 1's process with the gang liaison on
    (``"kill"``: ``--process-view 2``; rank 1 restarted once the
    engine resharded), then the recovery (healthy again / the restarted
    rank's rejoin), the grow-back at an idle tick, and wave 2 on the
    regrown mesh (its first ``n_wave2`` prompts, default all). Returns
    both waves' answers, rank 0's /stats, every
    rank process's generation reports, and the times: detection (kill
    to the liaison's verdict), reshard (kill or event to the rebuilt
    server), grow-back."""
    init = f"tcp://127.0.0.1:{_free_port()}"
    http_port = _free_port()
    mesh = ["--mesh", "tp=2", "--dist-init", init, "--max-reshards", "3"]
    if scenario == "kill":
        mesh += ["--process-view", "2"]
    env = dict(env or os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    logs: Dict[str, str] = {}
    procs = []

    def spawn(rank: int, tag: str):
        path = os.path.join(log_dir, f"elastic_{scenario}_{tag}.log")
        logs[tag] = path
        lf = open(path, "w")
        cmd = [sys.executable, "-m", "tpushare_torch.cli.serve",
               *engine_argv, *mesh, "--rank", str(rank),
               "--port", str(http_port if rank == 0 else 0)]
        p = subprocess.Popen(cmd, env=env, stdout=lf,
                             stderr=subprocess.STDOUT,
                             start_new_session=True)
        lf.close()
        procs.append(p)
        return p

    rec: Dict[str, object] = {"scenario": scenario}
    t0 = time.monotonic()
    r0 = spawn(0, "rank0")
    r1 = spawn(1, "rank1")
    try:
        if not _wait(lambda: _ready(http_port) or r0.poll() is not None,
                     timeout, 0.25) or r0.poll() is not None:
            raise RuntimeError("rank 0 never became ready: "
                               + _tail(logs["rank0"]))
        rec["ready_s"] = time.monotonic() - t0
        threads, wave1, codes1 = _wave(http_port, prompts, max_tokens,
                                       timeout)
        # Mid-wave: the first tokens are out, not every request done.
        _wait(lambda: _stats(http_port).get("tokens_out", 0) > 0,
              timeout, 0.02)
        st = _stats(http_port)
        rec["fault_at"] = {k: st.get(k) for k in ("tokens_out",
                                                  "completed")}
        t_fault = time.monotonic()
        if scenario == "kill":
            os.killpg(r1.pid, signal.SIGKILL)
            r1.wait(30)
        else:
            rec["chip_down"] = _http(http_port, "/mesh/chip",
                                     {"device": 1, "healthy": False})
        if scenario == "kill":
            _wait(lambda: (_stats(http_port).get("host_losses") or 0) >= 1,
                  timeout, 0.01)
            rec["detect_s"] = time.monotonic() - t_fault
        _wait(lambda: _stats(http_port).get("reshards", 0) >= 1, timeout,
              0.01)
        rec["reshard_s"] = time.monotonic() - t_fault
        for t in threads:
            t.join(timeout)
        rec["stats_degraded"] = _pick(_stats(http_port))
        t_back = time.monotonic()
        if scenario == "kill":
            spawn(1, "rank1_restarted")
        else:
            rec["chip_up"] = _http(http_port, "/mesh/chip",
                                   {"device": 1, "healthy": True})
        _wait(lambda: _stats(http_port).get("grow_backs", 0) >= 1,
              timeout, 0.05)
        rec["grow_back_s"] = time.monotonic() - t_back
        threads, wave2, codes2 = _wave(http_port, prompts[:n_wave2],
                                       max_tokens, timeout)
        for t in threads:
            t.join(timeout)
        st = _stats(http_port)
        rec["stats"] = _pick(st)
        rec["wave1"], rec["codes1"] = wave1, codes1
        rec["wave2"], rec["codes2"] = wave2, codes2
        os.killpg(r0.pid, signal.SIGTERM)       # drain, stop followers
        for p in procs:
            try:
                p.wait(60)
            except subprocess.TimeoutExpired:
                pass
        rec["rc"] = [p.returncode for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except OSError:
                    pass
                p.wait(30)
    rec["reports"] = {tag: _reports(path) for tag, path in logs.items()}
    return rec


_STATS_KEYS = ("reshards", "grow_backs", "replayed_on_reshard",
               "host_losses", "host_rejoins", "num_processes",
               "healthy_processes", "mesh_shape_current",
               "mesh_shape_configured", "degraded", "reshard_ms",
               "grow_back_ms", "fetches_per_tick", "mesh_generation",
               "mesh_digest", "mesh_digests", "mesh_generations",
               "mesh_transport", "gang", "engine_errors", "last_error",
               "completed", "replays", "quarantines")


def _pick(st: dict) -> dict:
    return {k: st.get(k) for k in _STATS_KEYS}


def _ready(port: int) -> bool:
    try:
        return _http(port, "/readyz", timeout=2.0)[0] == 200
    except OSError:
        return False


def _stats(port: int) -> dict:
    try:
        return _http(port, "/stats", timeout=30.0)[1]
    except OSError:
        return {}


def _tail(path: str) -> str:
    try:
        with open(path) as f:
            return f.read()[-3000:]
    except OSError:
        return ""


def _reports(path: str) -> List[dict]:
    out = []
    try:
        with open(path) as f:
            for line in f:
                if line.startswith('{"mesh_generation_report"'):
                    out.append(json.loads(line)["mesh_generation_report"])
    except OSError:
        pass
    return out


def main(argv=None) -> int:
    import argparse
    import tempfile

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scenario", default="kill", choices=["kill", "chip"])
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-tokens", type=int, default=8)
    ap.add_argument("--timeout-s", type=float, default=120.0)
    ap.add_argument("--n-layers", type=int, default=0,
                    help="the model's depth, cut from the preset's")
    from tpushare_torch.chaos.smoke import add_device_args
    add_device_args(ap)
    args = ap.parse_args(argv)

    liaison = _liaison_check()

    import dataclasses

    import numpy as np
    import torch

    from tpushare_torch import resolve_device
    from tpushare_torch.cli.serve import ServeEngine, _Request
    from tpushare_torch.models import transformer as tt

    dev = resolve_device(args.device or None)
    preset = args.preset or ("tiny" if dev.type == "cpu" else "llama3_8b")
    cfg = dataclasses.replace({"tiny": tt.tiny, "gemma_2b": tt.gemma_2b,
                               "llama3_8b": tt.llama3_8b}[preset](),
                              dtype=torch.float32)
    bs = 4 if preset == "tiny" else 16
    pool = ["--n-slots", "4", "--n-blocks", "128", "--block-size",
            str(bs), "--preset", preset, "--dtype", "float32",
            "--device", str(dev)]
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
        pool += ["--n-layers", str(args.n_layers)]
    rng = np.random.default_rng(19)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, 4 + i % 5)]
               for i in range(args.requests)]

    # Oracle: the single-process unsharded engine's greedy streams.
    oracle = ServeEngine(tt.init_params(0, cfg, device=dev), cfg,
                         n_slots=4, n_blocks=128, block_size=bs,
                         idle_sleep_s=0.0, device=dev)
    reqs = [_Request(list(p), args.max_tokens, None) for p in prompts]
    with oracle._on_device():
        for r in reqs:
            if not oracle.submit(r):
                raise RuntimeError("the oracle refused a request")
        for _ in range(4000):
            if all(r.done.is_set() for r in reqs):
                break
            oracle._loop_once()
    oracle.stop()
    want = [list(r.tokens) for r in reqs]
    del oracle

    with tempfile.TemporaryDirectory(prefix="tpushare-multihost-") as tmp:
        try:
            rec = run_elastic(pool, prompts, args.max_tokens,
                              scenario=args.scenario, log_dir=tmp,
                              timeout=args.timeout_s)
        except RuntimeError as e:
            print(json.dumps({"ok": False, "liaison": liaison,
                              "error": str(e)}), flush=True)
            return 1
    st = rec["stats"]
    lost = []
    for wave in ("wave1", "wave2"):
        for i, (got, code) in enumerate(zip(rec[wave],
                                            rec["codes" + wave[-1]])):
            if code == 429:
                continue                  # clean 429 at submit
            if code != 200 or got != want[i]:
                lost.append({"wave": wave, "i": i, "status": code,
                             "got": got, "want": want[i]})
    restarted = (rec["reports"].get("rank1_restarted") or
                 rec["reports"].get("rank1") or [])
    last = restarted[-1] if restarted else {}
    digests_equal = (last.get("mesh_generation") == st["mesh_generation"]
                     and last.get("digest") == st["mesh_digest"])
    crossed = ((st["host_losses"] or 0) >= 1 if args.scenario == "kill"
               else True) and st["reshards"] >= 1
    grew_back = (st["grow_backs"] >= 1
                 and st["mesh_shape_current"] == st["mesh_shape_configured"]
                 and (st["healthy_processes"] == st["num_processes"]))
    ok = liaison["ok"] and not lost and crossed and grew_back \
        and digests_equal
    print(json.dumps({
        "ok": ok, "scenario": args.scenario, "liaison": liaison,
        "accepted": 2 * len(prompts), "lost": lost,
        "host_losses": st["host_losses"],
        "host_rejoins": st["host_rejoins"],
        "reshards": st["reshards"], "grow_backs": st["grow_backs"],
        "replayed_on_reshard": st["replayed_on_reshard"],
        "num_processes": st["num_processes"],
        "healthy_processes": st["healthy_processes"],
        "mesh_shape_current": st["mesh_shape_current"],
        "fetches_per_tick": st["fetches_per_tick"],
        "digests_equal": digests_equal,
        "detect_s": rec.get("detect_s"), "reshard_s": rec["reshard_s"],
        "grow_back_s": rec["grow_back_s"],
        "reshard_ms": st["reshard_ms"], "grow_back_ms": st["grow_back_ms"],
        "last_error": st["last_error"],
        "mesh_transport": st["mesh_transport"], "preset": preset,
        "n_layers": cfg.n_layers, "device": str(dev),
    }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
