"""WC304 fixture — suppressed occurrence (probing a deliberately
unserved path to assert the 404 behavior itself)."""


class Handler:
    def _json(self, status, body):
        pass

    def do_GET(self):
        if self.path == "/ping":
            self._json(200, {"ok": True})
        else:
            self._json(404, {"error": "not found"})


def probe_unserved(conn):
    conn.request("GET", "/pong")  # tpushare: ignore[WC304]
    resp = conn.getresponse()
    return resp.status == 404
