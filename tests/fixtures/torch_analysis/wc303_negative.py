"""WC303 fixture — negatives: produced keys, and open shapes (an
unmodeled contribution must silence the rule, not flag)."""


def _extra():
    return {"dynamic": 1}


class Handler:
    def _json(self, status, body):
        pass

    def do_GET(self):
        if self.path == "/ping":
            self._json(200, {"ok": True, "uptime_s": 1.5})
        elif self.path == "/wide":
            self._json(200, dict(opaque_builder()))      # open shape
        else:
            self._json(404, {"error": "not found"})


def opaque_builder():
    return ()


def _fetch_json(rep, path):
    return {}


def poll(rep):
    body = _fetch_json(rep, "/ping")
    wide = _fetch_json(rep, "/wide")
    return body.get("ok"), body.get("uptime_s"), wide.get("anything")
