"""tpushare-torch-route: the cluster front-door HTTP daemon.

The port's copy of ``tpushare/router/daemon.py`` (a test holds its
code equal to the original's), in front of the port's engines.

One stdlib HTTP server in front of N ``tpushare-torch-serve``
replicas::

    tpushare-torch-route --replicas http://r0:8478,http://r1:8478 \
        --port 8080

The proxy surface is the engine's own contract — clients point at the
router instead of a replica and nothing else changes:

  POST /v1/completions  routed (prefix-affinity -> least-loaded),
                        retried across replicas on 503/timeout,
                        optionally hedged; SSE streams pass through
                        byte-for-byte. EXACTLY-ONCE: the
                        client's Idempotency-Key passes through —
                        and when the client sent none, the router
                        mints one per admission, so its own retry
                        and hedge paths (the documented
                        at-least-once hole) can never double-execute
                        an admission; a transport-level failure
                        retries WITHOUT excluding the replica (a
                        restarted daemon re-attaches the same key to
                        its journal-recovered request)
  GET  /v1/completions/{id}?from=N
                        stream resumption: the router asks its
                        replicas (404 = not mine) and pipes the
                        holder's event stream from cursor N
                        (Last-Event-ID honored) — a client that lost
                        its stream to a replica death reconnects
                        through the same front door
  GET  /healthz         router liveness (the poll thread is alive)
  GET  /readyz          router readiness (>= 1 replica routable)
  GET  /stats           router counters + per-replica score/breaker
  GET  /scale           autoscale advisory (recommended replica count
                        from pool-exhaustion + deadline-breach rates)

Shed behavior: when no replica is routable past the shed wait, the
request is refused 503 with a ``Retry-After`` header — the client-side
signal that the FLEET (not one replica) is saturated.

The router computes each prompt's block-aligned chain keys with the
same sha256 chain the paged prefix cache publishes
(tpushare_torch.router.chainkeys) and matches them against replica
``/prefixes`` gossip; the block size is learned from the gossip, so
the router needs zero model configuration.
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple

from tpushare_torch.chaos import ENV_CHAOS
from tpushare_torch.router.chainkeys import chain_keys_hex
from tpushare_torch.router.core import NoReplicaAvailable, Router
from tpushare_torch.slo import DEFAULT_TIER, TIER_ORDER, parse_tier


def request_tier(parsed, default: str = DEFAULT_TIER) -> str:
    """The request's shed/priority tier. Unknown or malformed tier
    names degrade to the DEFAULT here — the serving replica 400s the
    bad body itself, and the router must not invent a different
    answer for a request it merely forwards."""
    try:
        return parse_tier((parsed or {}).get("tier"), default)
    except ValueError:
        return default


def request_keys(router: Router, body: bytes
                 ) -> Tuple[List[str], int, Optional[dict]]:
    """(chain keys, publishable count, parsed body) for one admission.

    Unparseable bodies and unknown block sizes degrade to no-affinity
    (empty keys) — the replica will 400 a bad body itself, and before
    any gossip arrives least-loaded is the only sane policy anyway.
    Multi-LoRA requests salt the chain with the adapter id exactly
    like the server's prefix cache does: the same tokens under
    different adapters must never match the same blocks."""
    try:
        parsed = json.loads(body or b"{}")
        prompt = parsed.get("prompt")
        if (not isinstance(prompt, list)
                or not all(isinstance(t, int) for t in prompt)):
            return [], 0, parsed
    except (ValueError, AttributeError):
        return [], 0, None
    bs = None
    with router._lock:
        for rep in router.replicas:
            if rep.block_size:
                bs = rep.block_size
                break
    if not bs:
        return [], 0, parsed
    S = len(prompt)
    adapter = parsed.get("adapter", -1)
    # EXACTLY the engine's salt spelling (paged.py admit_start:
    # b"adapter:%d") — any byte of drift and adapter-salted chains
    # never match the gossip. The engine only salts when a multi-LoRA
    # bank is loaded, which the router can't see; base-model requests
    # (adapter -1) therefore go unsalted here and simply forfeit
    # affinity against a multi-LoRA replica's salted gossip (the
    # fallback still routes them) rather than mis-matching.
    salt = (b"" if adapter in (-1, None)
            else b"adapter:%d" % adapter)
    # Hash S//bs chains (every block the admission can publish); the
    # affinity match uses the admit-side bound (S-1)//bs of them, and
    # the learn-side records all S//bs.
    n_pub = S // bs
    keys = chain_keys_hex(prompt, bs, n_pub, salt=salt)
    return keys, n_pub, parsed


def make_handler(router: Router):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):          # quiet by default
            pass

        def _json(self, code: int, obj,
                  retry_after: Optional[float] = None) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if retry_after is not None:
                # The shed contract: a 503 with Retry-After means the
                # FLEET is saturated — back off, don't hot-loop.
                self.send_header("Retry-After",
                                 str(max(1, int(retry_after))))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                ok = router.healthy()
                self._json(200 if ok else 503, {"ok": ok})
            elif self.path == "/readyz":
                ok = router.ready()
                self._json(200 if ok else 503, {"ready": ok})
            elif self.path == "/stats":
                self._json(200, router.stats())
            elif self.path == "/scale":
                self._json(200, router.scale_advice())
            elif self.path.startswith("/v1/completions/"):
                self._proxy_resume()
            else:
                self._json(404, {"error": "not found"})

        def _proxy_resume(self) -> None:
            """Stream-resumption passthrough: find the replica
            holding the request id and pipe its event stream — the
            client's reconnect path after either side of a stream
            drops (incl. a replica death + journal recovery)."""
            import urllib.parse as _up
            parsed = _up.urlparse(self.path)
            rid = parsed.path[len("/v1/completions/"):]
            if not rid or "/" in rid:
                self._json(404, {"error": "not found"})
                return
            qs = _up.parse_qs(parsed.query)
            from_n = qs.get("from", [None])[0]
            leid = self.headers.get("Last-Event-ID")
            try:
                conn, resp, release = router.open_resume(
                    rid, from_n=from_n, last_event_id=leid)
            except NoReplicaAvailable as e:
                self._json(404, {"error": str(e)})
                return
            except ValueError:
                self._json(400, {"error": "from must be an int"})
                return
            self._pipe_stream(conn, resp, release)

        def do_POST(self):
            if self.path != "/v1/completions":
                self._json(404, {"error": "not found"})
                return
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
            keys, n_pub, parsed = request_keys(router, body)
            tier = request_tier(parsed, router.default_tier)
            stream = bool(parsed.get("stream")) if parsed else False
            # The client's own Idempotency-Key passes through; the
            # router mints one otherwise (core.py) — either way every
            # retry/hedge attempt of this admission shares one key.
            idem = self.headers.get("Idempotency-Key") or None
            # The quota principal rides into the migration
            # instruction: blocks pulled FOR this request land
            # in the sink's host tier against this tenant's budget.
            tenant = parsed.get("tenant") if parsed else None
            if not isinstance(tenant, str) or not tenant:
                tenant = None
            if stream:
                self._proxy_stream(body, keys, n_pub, tier, idem,
                                   tenant)
                return
            status, out = router.proxy_completion(body, keys, n_pub,
                                                  tier=tier,
                                                  idem_key=idem,
                                                  tenant=tenant)
            if status == 503 and "retry_after_s" in out:
                self._json(status, out,
                           retry_after=out["retry_after_s"])
            else:
                self._json(status, out)

        def _proxy_stream(self, body, keys, n_pub,
                          tier=DEFAULT_TIER, idem=None,
                          tenant=None) -> None:
            """SSE passthrough: events are forwarded as they arrive
            (unbuffered); routing/retry happens only before the first
            byte, so the client never sees a replayed token (after
            first byte, a drop is the client's cue to resume via
            GET /v1/completions/{id} with its Last-Event-ID)."""
            try:
                conn, resp, release = router.open_stream(body, keys,
                                                         n_pub,
                                                         tier=tier,
                                                         idem_key=idem,
                                                         tenant=tenant)
            except NoReplicaAvailable as e:
                self._json(503, {"error": str(e)},
                           retry_after=router.retry_after_s)
                return
            self._pipe_stream(conn, resp, release)

        def _pipe_stream(self, conn, resp, release) -> None:
            try:
                self.send_response(resp.status)
                ctype = resp.getheader("Content-Type",
                                       "text/event-stream")
                self.send_header("Content-Type", ctype)
                rid = resp.getheader("X-Request-Id")
                if rid:
                    self.send_header("X-Request-Id", rid)
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()      # close-delimited body
                while True:
                    chunk = resp.read(4096)
                    if not chunk:
                        break
                    self.wfile.write(chunk)
                    self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                pass                    # client gone; upstream closes
            finally:
                conn.close()
                release()               # stream leaves the live load
    return Handler


def serve_router(router: Router, host: str = "127.0.0.1",
                 port: int = 8080) -> ThreadingHTTPServer:
    """Start the router + its HTTP server; returns the running
    server. Caller owns shutdown: httpd.shutdown(); router.stop()."""
    router.start()
    httpd = ThreadingHTTPServer((host, port), make_handler(router))
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--replicas", required=True,
                    help="comma-separated engine replica base URLs, "
                         "e.g. http://r0:8478,http://r1:8478")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--policy", default="affinity",
                    choices=["affinity", "least_loaded", "random"],
                    help="affinity: longest chain-key match wins, "
                         "falling back to least-loaded; random exists "
                         "for A/B'ing the prefix-hit lift")
    ap.add_argument("--poll-interval-s", type=float, default=0.5,
                    help="replica /readyz + /stats + /prefixes poll "
                         "period (health scoring and breaker probes "
                         "ride this loop)")
    ap.add_argument("--breaker-threshold", type=int, default=3,
                    help="consecutive failures before a replica's "
                         "circuit breaker opens")
    ap.add_argument("--breaker-backoff-s", type=float, default=0.5,
                    help="initial breaker backoff (doubles per "
                         "re-open, capped by --breaker-backoff-max-s)")
    ap.add_argument("--breaker-backoff-max-s", type=float, default=30.0)
    ap.add_argument("--retry-budget", type=int, default=2,
                    help="extra replicas to try when an admission "
                         "503s/times out (idempotent retries only)")
    ap.add_argument("--hedge-ms", type=float, default=0,
                    help="fire a second replica after this many ms "
                         "without an answer; first success wins "
                         "(0 = off; latency-tier insurance)")
    ap.add_argument("--shed-wait-s", type=float, default=0.5,
                    help="how long an unroutable request of the "
                         "DEFAULT tier waits for a replica before "
                         "shedding 503 + Retry-After (batch sheds "
                         "immediately, interactive holds on for 2x)")
    ap.add_argument("--retry-after-s", type=float, default=1.0,
                    help="Retry-After seconds on shed responses")
    ap.add_argument("--request-timeout-s", type=float, default=300.0)
    ap.add_argument("--default-tier", default=DEFAULT_TIER,
                    choices=list(TIER_ORDER),
                    help="shed/priority tier for requests naming none "
                         "(shed order under saturation is batch -> "
                         "standard -> interactive: batch sheds "
                         "immediately, standard waits --shed-wait-s, "
                         "interactive 2x it)")
    ap.add_argument("--seed", type=int, default=0,
                    help="PRNG seed for --policy random draws")
    ap.add_argument("--chaos-spec", default=None,
                    help="deterministic fault injection at the "
                         "router's seams (router.proxy / "
                         "router.replica_stats), e.g. "
                         "'proxy:raise@p=0.1;seed=7'. Default: the "
                         f"{ENV_CHAOS} env var")
    ap.add_argument("--migrate-min-blocks", type=int, default=2,
                    help="cross-replica KV migration threshold (r18): "
                         "instruct the chosen replica to pull a "
                         "published chain from a sibling (POST "
                         "/kv/migrate) when the sibling's prefix "
                         "match beats the chosen replica's by at "
                         "least this many blocks (0 = never migrate)")
    return ap


def build_router(args) -> Router:
    """Router exactly as ``tpushare-torch-route`` builds it from parsed
    args — split from main() so tests and the smoke runner drive the real
    argv contract without binding a port."""
    urls = [u.strip() for u in args.replicas.split(",") if u.strip()]
    return Router(
        urls, policy=args.policy,
        poll_interval_s=args.poll_interval_s,
        breaker_threshold=args.breaker_threshold,
        breaker_backoff_s=args.breaker_backoff_s,
        breaker_backoff_max_s=args.breaker_backoff_max_s,
        retry_budget=args.retry_budget,
        hedge_ms=args.hedge_ms or None,
        shed_wait_s=args.shed_wait_s,
        retry_after_s=args.retry_after_s,
        request_timeout_s=args.request_timeout_s,
        seed=args.seed, chaos_spec=args.chaos_spec,
        default_tier=getattr(args, "default_tier", DEFAULT_TIER),
        migrate_min_blocks=getattr(args, "migrate_min_blocks", 2))


def main() -> int:
    args = build_arg_parser().parse_args()
    router = build_router(args)
    httpd = serve_router(router, args.host, args.port)
    print(f"tpushare-torch-route on {args.host}:{httpd.server_address[1]} "
          f"({args.policy}, {len(router.replicas)} replicas)",
          flush=True)
    import signal as _signal
    stop = threading.Event()
    _signal.signal(_signal.SIGTERM, lambda *_: stop.set())
    try:
        while not stop.is_set():
            stop.wait(1.0)
        httpd.shutdown()
        router.stop()
        return 0
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
