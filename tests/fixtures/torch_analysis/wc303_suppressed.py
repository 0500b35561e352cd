"""WC303 fixture — suppressed occurrence (deliberate forward-compat
read of a key the next server version will ship)."""


class Handler:
    def _json(self, status, body):
        pass

    def do_GET(self):
        if self.path == "/ping":
            self._json(200, {"ok": True})
        else:
            self._json(404, {"error": "not found"})


def _fetch_json(rep, path):
    return {}


def poll(rep):
    body = _fetch_json(rep, "/ping")
    return body.get("pong")  # tpushare: ignore[WC303]
