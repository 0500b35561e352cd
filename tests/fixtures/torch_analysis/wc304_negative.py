"""WC304 fixture — negatives: agreeing client, and a dynamic-status
endpoint (status set is a lower bound there, so no status check)."""


class Handler:
    def _json(self, status, body):
        pass

    def do_GET(self):
        if self.path == "/ping":
            ok = True
            self._json(200 if ok else 503, {"ok": ok})
        elif self.path == "/proxy":
            upstream = forward()
            self._json(upstream, {"ok": True})     # dynamic status
        else:
            self._json(404, {"error": "not found"})


def forward():
    return 200


def check(conn):
    conn.request("GET", "/ping")
    resp = conn.getresponse()
    return resp.status in (200, 503)


def check_proxy(conn):
    conn.request("GET", "/proxy")
    resp = conn.getresponse()
    return resp.status == 418              # dynamic: not checkable
