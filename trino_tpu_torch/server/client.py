"""Statement-protocol client + CLI (the StatementClientV1 / trino-cli
equivalent — client/trino-client/.../StatementClientV1.java:74,
client/trino-cli).  Stdlib http.client only; follows nextUri until the
query reaches a terminal state, accumulating data pages.

CLI: ``python -m trino_tpu_torch.server.client --server host:port
"select 1"``.  The port of the reference ``server/client.py``; host-only.
"""

from __future__ import annotations

import http.client
import json
import time
from typing import Optional

__all__ = ["Client", "QueryFailed", "main"]


class QueryFailed(RuntimeError):
    pass


class Client:
    def __init__(self, host: str = "127.0.0.1", port: int = 8080,
                 timeout: float = 300.0):
        self.host = host
        self.port = port
        self.timeout = timeout

    def _request(self, method: str, path: str, body: Optional[str] = None) -> dict:
        conn = http.client.HTTPConnection(self.host, self.port, timeout=30)
        try:
            conn.request(method, path, body=body)
            resp = conn.getresponse()
            return json.loads(resp.read().decode("utf-8"))
        finally:
            conn.close()

    def execute(self, sql: str) -> tuple[list[dict], list[list]]:
        """-> (columns, rows); raises QueryFailed on error states."""
        payload = self._request("POST", "/v1/statement", sql)
        columns: list[dict] = []
        rows: list[list] = []
        deadline = time.monotonic() + self.timeout
        while True:
            state = payload.get("stats", {}).get("state")
            if state == "FAILED":
                raise QueryFailed(payload.get("error", {}).get("message", "?"))
            columns = payload.get("columns", columns)
            rows.extend(payload.get("data", []))
            nxt = payload.get("nextUri")
            if nxt is None:
                if state in ("FINISHED", "CANCELED"):
                    return columns, rows
                raise QueryFailed(f"query ended in state {state}")
            if time.monotonic() > deadline:
                self.cancel(payload["id"])
                raise TimeoutError("client timed out; query cancelled")
            payload = self._request("GET", nxt)

    def cancel(self, query_id: str) -> None:
        self._request("DELETE", f"/v1/statement/{query_id}")


def main(argv: Optional[list[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="trino_tpu_torch SQL client")
    p.add_argument("--server", default="127.0.0.1:8080", help="host:port")
    p.add_argument("sql", help="SQL statement")
    args = p.parse_args(argv)
    host, _, port = args.server.partition(":")
    client = Client(host, int(port or 8080))
    columns, rows = client.execute(args.sql)
    if columns:
        print("\t".join(c["name"] for c in columns))
    for r in rows:
        print("\t".join("NULL" if v is None else str(v) for v in r))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
