"""Router-storm smoke over the port's engines: the counterpart of
``tpushare/router/smoke.py``.

Two in-process replicas built by the port's ``build_engine`` behind a
real ``tpushare_torch.router`` daemon, a seeded chaos spec arming the
router's own ``router.proxy`` seam, and a mixed-prefix request storm in
two waves — between them, replica 0 drains. Exit 0 iff:

  * nothing is lost — every request answers 200 with tokens
    BIT-IDENTICAL to a fault-free single-engine oracle (one port engine
    that never evicts), or a clean 503;
  * the storm exercised the machinery (router retries > 0);
  * REBALANCE is observed: after replica 0 drains, wave-2 traffic lands
    on replica 1 only.

Prints one JSON record either way::

    python -m tpushare_torch.router.smoke --device cpu
    python -m tpushare_torch.router.smoke --preset gemma_2b   # the card
"""

from __future__ import annotations

import argparse
import json
import threading
import time

DEFAULT_SPEC = "proxy:raise@p=0.2;seed=11"


def build_engine(device: str = "", preset: str = "tiny",
                 host_kv_bytes: int = 0, extra=()):
    """One port engine exactly as ``tpushare-torch-serve`` builds it
    from this argv (the smoke's pool: 2 slots, 48 blocks of 8)."""
    from tpushare_torch.cli.serve import build_engine as _build
    from tpushare_torch.cli.serve import build_parser
    argv = ["--preset", preset, "--n-slots", "2", "--n-blocks", "48",
            "--block-size", "8", "--host-kv-bytes", str(host_kv_bytes)]
    if device:
        argv += ["--device", device]
    eng = _build(build_parser().parse_args(argv + list(extra)))
    return eng, eng.srv.cfg


def run_requests(engine, prompts, max_tokens: int, timeout_s: float):
    """Submit every prompt, wait for every terminal transition, stop the
    engine. Returns (results, hung, stats, alive): results[i] =
    (tokens, error, status)."""
    from tpushare_torch.cli.serve import _Request
    engine.start()
    reqs = [_Request(list(p), max_tokens, None) for p in prompts]
    for r in reqs:
        if not engine.submit(r):
            raise RuntimeError("bounded queue refused a smoke request")
    hung = 0
    deadline = time.time() + timeout_s
    for r in reqs:
        if not r.done.wait(timeout=max(0.1, deadline - time.time())):
            hung += 1
    stats = engine.stats()
    alive = engine.healthy()
    engine.stop()
    return ([(list(r.tokens), r.error, r.status) for r in reqs],
            hung, stats, alive)


def _mixed_prefix_prompts(vocab: int, groups: int = 2,
                          per_group: int = 3, prefix_len: int = 16):
    """``groups`` shared prefixes x ``per_group`` distinct tails."""
    import numpy as np
    rng = np.random.default_rng(5)
    prompts = []
    for _ in range(groups):
        prefix = [int(t) for t in rng.integers(0, vocab, prefix_len)]
        for _ in range(per_group):
            tail = [int(t) for t in rng.integers(0, vocab, 4)]
            prompts.append(prefix + tail)
    return prompts


def post(port: int, path: str, obj, timeout_s: float):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=timeout_s)
    try:
        conn.request("POST", path, json.dumps(obj).encode(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


def storm(port: int, prompts, max_tokens: int, timeout_s: float):
    """Every prompt as one concurrent completion; (status, body) each,
    None where the transport died."""
    results = [None] * len(prompts)

    def go(i, p):
        try:
            results[i] = post(port, "/v1/completions",
                              {"prompt": p, "max_tokens": max_tokens},
                              timeout_s)
        except Exception as e:          # transport death = lost
            results[i] = (None, {"error": str(e)})

    threads = [threading.Thread(target=go, args=(i, p))
               for i, p in enumerate(prompts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s)
    return results


def tally(want, got):
    """(exact, clean_503, lost, mismatched) of routed answers against
    the oracle's token lists."""
    exact = clean_503 = lost = mismatched = 0
    for w, g in zip(want, got):
        if g is None or g[0] is None:
            lost += 1
            continue
        status, body = g
        if status == 200 and body.get("tokens") == w:
            exact += 1
        elif status == 503:
            clean_503 += 1
        elif status == 200:
            mismatched += 1
        else:
            lost += 1
    return exact, clean_503, lost, mismatched


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--spec", default=DEFAULT_SPEC)
    ap.add_argument("--device", default="",
                    help="'cpu' for the plain path; default the card")
    ap.add_argument("--preset", default="tiny")
    ap.add_argument("--max-tokens", type=int, default=5)
    ap.add_argument("--timeout-s", type=float, default=120.0)
    args = ap.parse_args(argv)

    from tpushare_torch.cli import serve as serve_mod
    from tpushare_torch.router import Router
    from tpushare_torch.router.daemon import serve_router

    oracle, cfg = build_engine(args.device, args.preset)
    prompts = _mixed_prefix_prompts(cfg.vocab_size)
    want, hung, _, alive = run_requests(oracle, prompts,
                                        args.max_tokens, args.timeout_s)
    if hung or not alive or any(err for _, err, _ in want):
        print(json.dumps({"ok": False,
                          "error": "oracle (single-engine) run failed"}),
              flush=True)
        return 1

    replicas = []
    for _ in range(2):
        eng, _ = build_engine(args.device, args.preset)
        httpd = serve_mod.serve(eng, host="127.0.0.1", port=0)
        replicas.append((eng, httpd, httpd.server_address[1]))
    urls = [f"http://127.0.0.1:{p}" for _, _, p in replicas]
    router = Router(urls, poll_interval_s=0.1, breaker_threshold=3,
                    retry_budget=2, shed_wait_s=1.0,
                    chaos_spec=args.spec)
    rhttpd = serve_router(router, "127.0.0.1", 0)
    rport = rhttpd.server_address[1]
    router.poll_once()                  # learn block sizes before wave 1

    try:
        wave1 = storm(rport, prompts, args.max_tokens, args.timeout_s)
        replicas[0][0].begin_drain()
        router.poll_once()              # observe not-ready now
        r0_before = router.replicas[0].proxied
        wave2 = storm(rport, prompts, args.max_tokens, args.timeout_s)
        r0_after = router.replicas[0].proxied
        r1_served = router.replicas[1].proxied
        rstats = router.stats()
    finally:
        rhttpd.shutdown()
        router.stop()
        for eng, httpd, _ in replicas:
            httpd.shutdown()
            eng.stop()

    tokens = [w for w, _, _ in want]
    exact, clean_503, lost, mismatched = tally(tokens + tokens,
                                               wave1 + wave2)
    rebalanced = (r0_after == r0_before and r1_served > 0)
    ok = (lost == 0 and mismatched == 0 and exact > 0
          and rstats["retries"] > 0 and rebalanced)
    print(json.dumps({
        "ok": ok, "spec": args.spec, "requests": 2 * len(prompts),
        "token_exact": exact, "clean_503": clean_503,
        "mismatched": mismatched, "lost_or_dirty": lost,
        "rebalanced": rebalanced,
        "replica0_proxied": r0_after, "replica1_proxied": r1_served,
        "retries": rstats["retries"], "shed": rstats["shed"],
        "breaker_opens": rstats["breaker_opens"],
        "affinity_hits": rstats["affinity_hits"],
        "chaos_fired": rstats.get("chaos_fired"),
    }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
