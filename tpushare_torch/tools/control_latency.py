"""Per-message latency of a sharded engine's control channel.

Rank 0 of a ``--mesh`` engine sends every state-changing server call to
the other ranks before it runs it (``parallel/control.py``). The
channel is the mesh generation's TCP store (``StoreChannel``: rank 0
sets a key, a follower polls for it); before mesh generations it was a
gloo ``broadcast_object_list`` on a control group. This tool times both
between two processes of one host, at the gaps a tick leaves between
messages (back to back, a few ms, one NCCL tick, one gloo stand-in
tick), with a message of a tick's shape::

    python -m tpushare_torch.tools.control_latency --n 200

For each channel and gap it prints one JSON line: the follower's
latency (rank 0's send to the follower's receive, ms: p50, p99, mean)
and the time rank 0's send call holds it (ms: p50, p99). The last line
is the whole record.
"""

from __future__ import annotations

import argparse
import datetime
import json
import socket
import time

GAPS_MS = (0.0, 5.0, 60.0, 900.0)
CHANNELS = ("store", "gloo")


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def _summary(xs):
    ms = [x * 1e3 for x in xs]
    return {"p50": _pct(ms, 0.5), "p99": _pct(ms, 0.99),
            "mean": sum(ms) / len(ms)}


def _message(seq: int):
    """A step_async call as rank 0 sends it: four slots' tokens."""
    return ("call", seq, "step_async", ([101, 7, 9, 4000],),
            {"horizon": 1})


def _worker(rank: int, port: int, n: int, gaps, channels, out) -> None:
    import pickle

    import torch.distributed as dist

    from tpushare_torch.parallel.control import StoreChannel
    timeout = datetime.timedelta(seconds=120)
    store = dist.TCPStore("127.0.0.1", port, 2, rank == 0,
                          timeout=timeout)
    dist.init_process_group(
        "gloo", store=dist.PrefixStore("pg", store), rank=rank,
        world_size=2, timeout=timeout)
    res = {}
    for channel in channels:
        for gap in gaps:
            k = max(2, n if gap < 100 else n // 20)
            name = f"{channel}/{gap:g}ms"
            chan = StoreChannel(dist.PrefixStore(name, store), 120.0,
                                lambda: False)
            dist.barrier()
            sends, lats = [], []
            for i in range(k):
                if rank == 0:
                    if gap:
                        time.sleep(gap / 1e3)
                    t0 = time.monotonic()
                    msg = (t0, _message(i + 1))
                    if channel == "store":
                        chan.send(msg)
                    else:
                        dist.broadcast_object_list([msg], src=0)
                    sends.append(time.monotonic() - t0)
                else:
                    if channel == "store":
                        msg = chan.recv()
                    else:
                        box = [None]
                        dist.broadcast_object_list(box, src=0)
                        msg = box[0]
                    lats.append(time.monotonic() - msg[0])
            dist.barrier()
            if rank == 0:
                res[name] = {"messages": k, "send_ms": _summary(sends)}
            else:
                store.set(f"res/{name}", pickle.dumps(_summary(lats)))
    if rank == 0:
        for name in res:
            store.wait([f"res/{name}"])
            res[name]["latency_ms"] = pickle.loads(
                store.get(f"res/{name}"))
        out.put(res)
    dist.destroy_process_group()


def measure(n: int = 200, gaps=GAPS_MS, channels=CHANNELS) -> dict:
    """Both channels at every gap, two processes of this host."""
    import torch.multiprocessing as mp
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_worker,
                         args=(r, port, n, tuple(gaps), tuple(channels),
                               out))
             for r in range(2)]
    for p in procs:
        p.start()
    import queue
    try:
        deadline = time.monotonic() + 600
        while True:
            try:
                res = out.get(timeout=1.0)
                break
            except queue.Empty:
                if time.monotonic() > deadline or \
                        any(p.exitcode not in (None, 0) for p in procs):
                    raise RuntimeError(
                        f"control_latency: workers exited "
                        f"{[p.exitcode for p in procs]}") from None
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=200,
                    help="messages per channel and gap (a twentieth at "
                         "the 900 ms gap)")
    args = ap.parse_args(argv)
    res = measure(args.n)
    for name, rec in res.items():
        print(json.dumps({"channel": name, **rec}), flush=True)
    print(json.dumps({"control_latency": res}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
