"""Offload+migration smoke over the port's engines: the counterpart of
``tpushare/router/offload_smoke.py``.

Two in-process port replicas, each with a host offload tier, behind a
real ``tpushare_torch.router``. Replica 0 is warmed with shared-prefix
prompts (its pool publishes the chains), then DRAINED — so the
follow-up storm must land on replica 1, and the router's ``/kv/migrate``
instruction is the only way replica 1 can reuse the chains replica 0
holds instead of recomputing them. Exit 0 iff:

  * migration moved state: the router instructed pulls and the sink
    reported landed blocks (``migrations_instructed`` > 0,
    ``migrated_blocks`` > 0), replica 1's ``host_tier.migrations_in``
    climbed, and admissions PROMOTED migrated chains
    (``host_tier.promotions`` > 0);
  * nothing is lost: every storm answer is 200 with tokens
    BIT-IDENTICAL to a single port engine that never evicts, or a clean
    503;
  * one fetch per tick held with the tier and prefetch active: replica
    1's ``fetches_per_tick`` <= 1.0.

Prints one JSON record either way::

    python -m tpushare_torch.router.offload_smoke --device cpu
"""

from __future__ import annotations

import argparse
import json

from tpushare_torch.router.smoke import (build_engine, run_requests, storm,
                                         tally)


def _prompts(vocab: int, groups: int = 2, per_group: int = 3,
             prefix_len: int = 16, tail_len: int = 4):
    """Shared prefixes x distinct tails; every group prefix spans >= 2
    full blocks at the smoke pool's block size (8), the migration
    threshold's default."""
    import numpy as np
    rng = np.random.default_rng(7)
    out = []
    for _ in range(groups):
        prefix = [int(t) for t in rng.integers(0, vocab, prefix_len)]
        for _ in range(per_group):
            tail = [int(t) for t in rng.integers(0, vocab, tail_len)]
            out.append(prefix + tail)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
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
    prompts = _prompts(cfg.vocab_size)
    want, hung, _, alive = run_requests(oracle, prompts,
                                        args.max_tokens, args.timeout_s)
    if hung or not alive or any(err for _, err, _ in want):
        print(json.dumps({"ok": False,
                          "error": "oracle (single-engine) run failed"}),
              flush=True)
        return 1

    replicas = []
    for _ in range(2):
        eng, _ = build_engine(args.device, args.preset,
                              host_kv_bytes=32 << 20)
        httpd = serve_mod.serve(eng, host="127.0.0.1", port=0)
        replicas.append((eng, httpd, httpd.server_address[1]))
    urls = [f"http://127.0.0.1:{p}" for _, _, p in replicas]
    router = Router(urls, poll_interval_s=0.1, breaker_threshold=3,
                    retry_budget=2, shed_wait_s=1.0,
                    migrate_min_blocks=2)
    rhttpd = serve_router(router, "127.0.0.1", 0)
    rport = rhttpd.server_address[1]

    try:
        # Warm replica 0 DIRECTLY (not through the router): its pool
        # publishes every group's chain, nobody else holds anything.
        warm = storm(replicas[0][2], prompts, args.max_tokens,
                     args.timeout_s)
        if any(r is None or r[0] != 200 for r in warm):
            print(json.dumps({"ok": False,
                              "error": "replica-0 warm phase failed"}),
                  flush=True)
            return 1
        router.poll_once()              # learn replica 0's gossip
        # Drain replica 0: not routable for NEW admissions but alive —
        # the migration-source shape (GET /kv/blocks still answers).
        replicas[0][0].begin_drain()
        router.poll_once()              # observe not-ready
        results = storm(rport, prompts, args.max_tokens, args.timeout_s)
        rstats = router.stats()
        r1_stats = replicas[1][0].stats()
    finally:
        rhttpd.shutdown()
        router.stop()
        for eng, httpd, _ in replicas:
            httpd.shutdown()
            eng.stop()

    exact, clean_503, lost, mismatched = tally(
        [w for w, _, _ in want], results)
    ht = r1_stats.get("host_tier") or {}
    fpt = r1_stats.get("fetches_per_tick")
    ok = (lost == 0 and mismatched == 0 and exact > 0
          and rstats["migrations_instructed"] > 0
          and rstats["migrated_blocks"] > 0
          and (ht.get("migrations_in") or 0) > 0
          and (ht.get("promotions") or 0) > 0
          and (fpt is None or fpt <= 1.0))
    print(json.dumps({
        "ok": ok, "requests": len(prompts),
        "token_exact": exact, "clean_503": clean_503,
        "mismatched": mismatched, "lost_or_dirty": lost,
        "migrations_instructed": rstats["migrations_instructed"],
        "migrations_failed": rstats["migrations_failed"],
        "migrated_blocks": rstats["migrated_blocks"],
        "sink_migrations_in": ht.get("migrations_in"),
        "sink_promotions": ht.get("promotions"),
        "sink_prefetch_hit_rate": ht.get("prefetch_hit_rate"),
        "fetches_per_tick": fpt,
    }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
