"""WC303 fixture — true positive. Parsed by the analyzer, never run.

Self-contained wire world: the handler below is the only producer in
view (fixture fallback mode), so the consumer's key set is checked
against its closed response shape.
"""


class Handler:
    def _json(self, status, body):
        pass

    def do_GET(self):
        if self.path == "/ping":
            self._json(200, {"ok": True, "uptime_s": 1.5})
        else:
            self._json(404, {"error": "not found"})


def _fetch_json(rep, path):
    return {}


def poll(rep):
    body = _fetch_json(rep, "/ping")
    return body.get("pong")               # WC303: no handler writes it
