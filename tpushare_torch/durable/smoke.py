"""Crash-recovery smoke: the CI teeth of crash-only serving.
Counterpart of ``tpushare/durable/smoke.py``: the same exit rule and
JSON keys, over the port's daemon and router.

A REAL ``python -m tpushare_torch.cli.serve`` process (journal on)
behind the port's REAL router front door, SIGKILL'd between request
waves, restarted on the same journal directory. Exit 0 iff the
crash-only contract holds end to end:

  * nothing is lost — every wave-1 request either completed before the
    kill, or its idempotent wave-2 re-submit (same ``Idempotency-Key``)
    returns tokens BIT-IDENTICAL to a fault-free in-process oracle (the
    restarted daemon recovered it from the journal and finished it
    token-exact), or it answers a clean 503;
  * nothing is double-executed — a re-submitted admission returns the
    SAME completion (the dedupe window survived the kill);
  * the machinery actually ran: ``recovered_requests > 0`` AND
    ``dedup_hits > 0`` on the restarted daemon.

The daemon runs on ``--device`` (passed through to the child; the
default is the card) at ``--preset`` (``tiny`` on the CPU, Gemma-2B in
f32 on the card, as ``chaos/smoke.py``). Every child gets a port from
the OS and a hard time limit. ``--journal off`` runs the daemon
without its journal, a run the gate must fail. Prints one JSON record
either way::

    python -m tpushare_torch.durable.smoke --device cpu --preset tiny
    python -m tpushare_torch.durable.smoke --requests 6 --max-tokens 48
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time


def _post(port: int, obj, timeout_s: float, idem_key=None):
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=timeout_s)
    headers = {"Content-Type": "application/json"}
    if idem_key:
        headers["Idempotency-Key"] = idem_key
    try:
        conn.request("POST", "/v1/completions",
                     json.dumps(obj).encode(), headers)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


def _get_json(port: int, path: str, timeout_s: float = 5.0):
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=timeout_s)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


def _spawn_serve(args, journal_dir: str, port: int, log):
    """Launch the real daemon; returns the Popen. The child gets its
    own process group so the SIGKILL below cannot touch the harness,
    and this smoke's --device and preset, in f32 as the oracle."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-m", "tpushare_torch.cli.serve",
           "--preset", args.preset, "--dtype", "float32",
           "--device", str(args.device), "--port", str(port),
           "--n-slots", "2", "--n-blocks", "48",
           "--block-size", "8" if args.preset == "tiny" else "16"]
    if args.journal == "on":
        cmd += ["--journal-dir", journal_dir, "--journal-fsync", "off"]
    return subprocess.Popen(cmd, env=env, start_new_session=True,
                            stdout=log, stderr=subprocess.STDOUT)


def _wait_ready(proc, port: int, deadline_s: float) -> bool:
    deadline = time.time() + deadline_s
    while time.time() < deadline and proc.poll() is None:
        try:
            status, _ = _get_json(port, "/readyz", timeout_s=2.0)
            if status == 200:
                return True
        except OSError:
            pass
        time.sleep(0.25)
    return False


def _find_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _kill(proc) -> None:
    """SIGKILL the child's whole process group and reap it."""
    if proc is None or proc.poll() is not None:
        return
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except OSError:
        proc.kill()
    proc.wait(timeout=30)


def main(argv=None) -> int:
    from tpushare_torch.chaos.smoke import add_device_args
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--max-tokens", type=int, default=48)
    ap.add_argument("--boot-timeout-s", type=float, default=240.0)
    ap.add_argument("--timeout-s", type=float, default=240.0)
    ap.add_argument("--journal", default="on", choices=["on", "off"])
    add_device_args(ap)
    args = ap.parse_args(argv)

    from tpushare_torch import resolve_device
    from tpushare_torch.chaos.smoke import (_free, build_engine, launches,
                                            run_requests)
    dev = resolve_device(args.device or None)
    args.device = dev
    args.preset = args.preset or ("tiny" if dev.type == "cpu"
                                  else "gemma_2b")

    # Fault-free in-process oracle (greedy, the child's seed, config and
    # dtype): the recovered continuations must be bit-identical to it.
    import numpy as np
    oracle, cfg = build_engine("dense", preset=args.preset, device=dev)
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size,
                                             4 + 3 * (i % 3))]
               for i in range(args.requests)]
    want, hung, _, alive = run_requests(oracle, prompts,
                                        args.max_tokens,
                                        args.timeout_s)
    del oracle
    _free(dev)
    if hung or not alive or any(err for _, err, _ in want):
        print(json.dumps({"ok": False,
                          "error": "oracle (in-process) run failed"}),
              flush=True)
        return 1
    want_tokens = [w for w, _, _ in want]

    journal_dir = tempfile.mkdtemp(prefix="tpushare-torch-journal-")
    log = open(os.path.join(journal_dir, "serve.log"), "ab")
    port = _find_port()
    proc = _spawn_serve(args, journal_dir, port, log)
    record = {"ok": False, "journal_mode": args.journal,
              "preset": args.preset, "device": str(dev)}
    proc2 = None
    router = rhttpd = None
    try:
        if not _wait_ready(proc, port, args.boot_timeout_s):
            record["error"] = "serve process never became ready"
            print(json.dumps(record), flush=True)
            return 1

        from tpushare_torch.router import Router
        from tpushare_torch.router.daemon import serve_router
        router = Router([f"http://127.0.0.1:{port}"],
                        poll_interval_s=0.2, retry_budget=2,
                        shed_wait_s=1.0, request_timeout_s=30.0)
        rhttpd = serve_router(router, "127.0.0.1", 0)
        rport = rhttpd.server_address[1]
        router.poll_once()

        # Wave 1 (through the front door, client-held idempotency
        # keys): fire-and-SIGKILL — long generations make the kill land
        # mid-stream for most requests.
        results1 = [None] * len(prompts)

        def go(i, p):
            try:
                results1[i] = _post(rport, {"prompt": p,
                                            "max_tokens":
                                            args.max_tokens},
                                    30.0, idem_key=f"smoke-{i}")
            except Exception as e:
                results1[i] = (None, {"error": str(e)})

        threads = [threading.Thread(target=go, args=(i, p), daemon=True)
                   for i, p in enumerate(prompts)]
        for t in threads:
            t.start()
        # Kill -9 the serve process the moment generation is in flight
        # (first tokens out, not yet all complete): the journal (the
        # page cache survives process death) is all that remains.
        kill_deadline = time.time() + 60.0
        while time.time() < kill_deadline:
            try:
                _, st = _get_json(port, "/stats", timeout_s=2.0)
                if st.get("tokens_out", 0) > 0 and \
                        st.get("completed", 0) < len(prompts):
                    break
            except OSError:
                pass
            time.sleep(0.05)
        _kill(proc)
        for t in threads:
            t.join(60.0)
        record["wave1"] = [r[0] if r else None for r in results1]

        # Restart on the same journal; the daemon recovers and finishes
        # every accepted stream on its own.
        proc2 = _spawn_serve(args, journal_dir, port, log)
        if not _wait_ready(proc2, port, args.boot_timeout_s):
            record["error"] = "restarted process never became ready"
            print(json.dumps(record), flush=True)
            return 1
        router.poll_once()

        # Wave 2: idempotent re-submits of EVERY wave-1 request. Each
        # must return the oracle's exact tokens — recovered + finished,
        # or deduped to the already-completed result — never a
        # re-execution, never a duplicate.
        exact = clean_503 = lost = mismatched = 0
        for i, p in enumerate(prompts):
            try:
                status, body = _post(rport, {"prompt": p,
                                             "max_tokens":
                                             args.max_tokens},
                                     args.timeout_s,
                                     idem_key=f"smoke-{i}")
            except Exception as e:
                lost += 1
                record.setdefault("errors", []).append(str(e))
                continue
            if status == 200 and body.get("tokens") == want_tokens[i]:
                exact += 1
            elif status == 503:
                clean_503 += 1
            elif status == 200:
                mismatched += 1
                record.setdefault("mismatches", []).append(
                    {"i": i, "got": body.get("tokens"),
                     "want": want_tokens[i]})
            else:
                lost += 1
                record.setdefault("errors", []).append(
                    {"i": i, "status": status, "body": body})
        _, stats = _get_json(port, "/stats")
        record.update({
            "requests": len(prompts), "token_exact": exact,
            "clean_503": clean_503, "mismatched": mismatched,
            "lost_or_dirty": lost,
            "recovered_requests": stats.get("recovered_requests"),
            "dedup_hits": stats.get("dedup_hits"),
            "journal": stats.get("journal"),
            "oracle_launches": launches(),
        })
        record["ok"] = (lost == 0 and mismatched == 0 and exact > 0
                        and (stats.get("recovered_requests") or 0) > 0
                        and (stats.get("dedup_hits") or 0) > 0)
        print(json.dumps(record), flush=True)
        return 0 if record["ok"] else 1
    finally:
        for p in (proc, proc2):
            _kill(p)
        if rhttpd is not None:
            rhttpd.shutdown()
            rhttpd.server_close()
        if router is not None:
            router.stop()
        log.close()
        shutil.rmtree(journal_dir, ignore_errors=True)


if __name__ == "__main__":
    raise SystemExit(main())
