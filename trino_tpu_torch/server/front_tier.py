"""Stateless HTTP front tier for the HA coordinator fleet.

The port of the reference ``server/front_tier.py``: a router in front of
N coordinators.  Clients speak the ordinary statement protocol
(server/protocol.py) to one stable address and never learn the fleet's
topology.

- ``POST /v1/statement``: the tier mints the query id itself and forwards
  to the owning coordinator, the rendezvous hash over the live membership
  (execution/ha.py ``owner_of``), passing the id down in the
  ``X-Trino-Tpu-Query-Id`` header so routing and identity agree.
- ``GET /v1/statement/{id}/{token}`` / ``DELETE``: routed by the same
  hash.  When the owner is unreachable or does not know the query (it
  died and a peer adopted the query), the tier probes every live member
  and pins the one that answers (``trino_ha_reroutes_total``).  While
  nobody answers (the takeover window), a poll gets a synthetic
  ``QUEUED`` page with an unchanged ``nextUri`` for up to
  ``TRINO_TPU_HA_ROUTE_RETRY_S``, so a client polling through a failover
  sees a slow query, not an error.

The tier holds no query state, no tensor and no device: every response is
recomputed from the lease directory plus one proxied upstream call, so
any number of tiers can run behind one load balancer (the routing pins
are a latency cache that may be lost).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..execution import ha
from ..spi.knobs import get_float
from ..telemetry import metrics as tm

__all__ = ["FrontTier"]


class _Upstream:
    """One proxied call's outcome."""

    __slots__ = ("status", "body")

    def __init__(self, status: int, body: bytes):
        self.status = status
        self.body = body


def _call(url: str, method: str, body: Optional[bytes] = None,
          headers: Optional[dict] = None,
          timeout: float = 30.0) -> Optional[_Upstream]:
    """One HTTP round trip; None on a transport failure (a dead
    coordinator)."""
    req = urllib.request.Request(url, data=body, method=method)
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return _Upstream(resp.status, resp.read())
    except urllib.error.HTTPError as e:
        return _Upstream(e.code, e.read())
    except (urllib.error.URLError, OSError):
        return None


class FrontTier:
    """Stateless statement-protocol router over the coordinator fleet."""

    def __init__(self, root: Optional[str] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 ttl: Optional[float] = None,
                 retry_s: Optional[float] = None,
                 call_timeout: float = 30.0):
        self.root = root or ha.ha_dir()
        self.ttl = ha.lease_ttl_s() if ttl is None else ttl
        self.retry_s = (get_float("TRINO_TPU_HA_ROUTE_RETRY_S") or 15.0
                        ) if retry_s is None else retry_s
        self.call_timeout = call_timeout
        # qid -> url of the coordinator that last answered for it (a pin,
        # safe to lose); qid -> first miss (the failover grace window)
        self._pins: dict[str, str] = {}
        self._misses: dict[str, float] = {}
        self._lock = threading.Lock()
        handler = type("_BoundFrontHandler", (_FrontHandler,),
                       {"tier": self})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- topology
    def members(self) -> list:
        return ha.live_members(self.root, self.ttl)

    def owner_url(self, qid: str) -> Optional[str]:
        members = self.members()
        owner = ha.owner_of(qid, [m.node_id for m in members])
        for m in members:
            if m.node_id == owner:
                return m.url
        return None

    # -------------------------------------------------------------- routing
    def route_post(self, sql: bytes) -> tuple[int, dict]:
        qid = uuid.uuid4().hex[:16]
        deadline = time.monotonic() + self.retry_s
        while True:
            url = self.owner_url(qid)
            if url is not None:
                up = _call(f"{url}/v1/statement", "POST", body=sql,
                           headers={"X-Trino-Tpu-Query-Id": qid},
                           timeout=self.call_timeout)
                if up is not None:
                    with self._lock:
                        self._pins[qid] = url
                    return up.status, _decode(up.body)
            # the owner is down and not yet claimed: wait out a slice of
            # the failover window and rehash over the new membership
            if time.monotonic() >= deadline:
                return 503, {"error": {
                    "message": "no live coordinator for query"}}
            time.sleep(0.1)

    def route_query(self, qid: str, path: str,
                    method: str = "GET") -> tuple[int, dict]:
        """Route one ``/v1/statement/{qid}/...`` poll (or DELETE)."""
        tried = []
        with self._lock:
            pin = self._pins.get(qid)
        candidates = [pin] if pin else []
        owner = self.owner_url(qid)
        if owner and owner not in candidates:
            candidates.append(owner)
        for url in candidates:
            up = _call(f"{url}{path}", method, timeout=self.call_timeout)
            tried.append(url)
            if up is not None and up.status == 200:
                self._answered(qid, url)
                return up.status, _decode(up.body)
        # the routed coordinator is dead or disowned the query: a peer may
        # have adopted it, so probe the whole live fleet
        for m in self.members():
            if m.url in tried:
                continue
            up = _call(f"{m.url}{path}", method, timeout=self.call_timeout)
            if up is not None and up.status == 200:
                tm.HA_REROUTES.inc()
                self._answered(qid, m.url)
                return up.status, _decode(up.body)
        if method == "GET":
            # nobody answers: inside the takeover window the client sees a
            # synthetic QUEUED page and keeps polling the same nextUri
            now = time.monotonic()
            with self._lock:
                first = self._misses.setdefault(qid, now)
            if now - first <= self.retry_s:
                return 200, {"id": qid, "stats": {"state": "QUEUED"},
                             "nextUri": path}
        return 404, {"error": {"message": f"unknown query {qid}"}}

    def _answered(self, qid: str, url: str) -> None:
        with self._lock:
            self._pins[qid] = url
            self._misses.pop(qid, None)
            if len(self._pins) > 4096:  # stateless: pins are disposable
                self._pins.clear()

    # ------------------------------------------------------------ lifecycle
    @property
    def address(self) -> tuple[str, int]:
        return self.httpd.server_address[:2]

    def start(self) -> "FrontTier":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="trino-tpu-front-tier",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)


def _decode(body: bytes) -> dict:
    try:
        out = json.loads(body)
        return out if isinstance(out, dict) else {"value": out}
    except ValueError:
        return {"error": {"message": "bad upstream payload"}}


class _FrontHandler(BaseHTTPRequestHandler):
    tier: FrontTier = None  # set by FrontTier

    def log_message(self, fmt, *args):  # quiet
        pass

    def _send(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        if self.path.rstrip("/") != "/v1/statement":
            self._send(404, {"error": {"message": "not found"}})
            return
        length = int(self.headers.get("Content-Length", "0"))
        code, payload = self.tier.route_post(self.rfile.read(length))
        self._send(code, payload)

    def do_GET(self):
        parts = [p for p in self.path.split("?")[0].split("/") if p]
        if parts == ["v1", "metrics"]:
            body = tm.REGISTRY.render_prometheus().encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if len(parts) == 4 and parts[:2] == ["v1", "statement"]:
            code, payload = self.tier.route_query(parts[2], self.path)
            self._send(code, payload)
            return
        self._send(404, {"error": {"message": "not found"}})

    def do_DELETE(self):
        parts = [p for p in self.path.strip("/").split("/") if p]
        if len(parts) >= 3 and parts[:2] == ["v1", "statement"]:
            code, payload = self.tier.route_query(parts[2], self.path,
                                                  method="DELETE")
            self._send(code, payload)
            return
        self._send(404, {"error": {"message": "not found"}})
