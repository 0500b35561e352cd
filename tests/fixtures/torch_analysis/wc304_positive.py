"""WC304 fixture — true positives. Parsed by the analyzer, never run.

Three drifts against the one handler in view: a path nothing serves, a
method the path doesn't accept, and an expected status the handler
never emits.
"""


class Handler:
    def _json(self, status, body):
        pass

    def do_GET(self):
        if self.path == "/ping":
            self._json(200, {"ok": True})
        else:
            self._json(404, {"error": "not found"})


def check_gone(conn):
    conn.request("GET", "/pong")          # WC304: no handler serves it
    resp = conn.getresponse()
    return resp.status == 200


def check_method(conn):
    conn.request("POST", "/ping")         # WC304: served, but not POST
    resp = conn.getresponse()
    return resp.status == 200


def check_status(conn):
    conn.request("GET", "/ping")          # WC304: handler never emits 503
    resp = conn.getresponse()
    return resp.status in (200, 503)
