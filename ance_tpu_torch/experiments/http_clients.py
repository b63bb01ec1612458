"""Closed-loop clients of the search server: ``n`` threads, each POSTing
one body to ``/search`` back to back until told to stop, with each
request's latency as its client saw it (queueing included).

Standard library only, so that it also runs as a process of its own, by
path, with no package on its path (the second client arm of
``perf_liveserve.py``, which keeps the clients' JSON and sockets off the
serving process's interpreter lock):

    python http_clients.py  < first line: {"url", "body", "clients",
                                           "batch", "k"}; a second line
                                           (or the end of input) stops

It prints ``{"started": true}`` once its threads run and, after the stop,
one JSON object: the latencies, the window's seconds, and the requests
that failed or came back with fewer than ``batch`` rows of ``k`` hits.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import urllib.request


def post(url: str, body: bytes, timeout: float = 120.0) -> dict:
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


class Clients:
    """``clients`` threads POSTing ``body`` to ``url`` back to back."""

    def __init__(self, url: str, body: dict, clients: int, batch: int,
                 k: int):
        self.url, self.body = url, json.dumps(body).encode()
        self.batch, self.k = batch, k
        self.lat_ms: list[float] = []
        self.errors = self.partial = 0
        self.first_error = None
        self._count = threading.Lock()
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._worker, daemon=True,
                                          name=f"http-client-{i}")
                         for i in range(clients)]
        self._t0 = 0.0

    def _worker(self) -> None:
        while not self._stop.is_set():
            t0 = time.perf_counter()
            try:
                reply = post(self.url, self.body)
            except Exception as e:  # noqa: BLE001  (counted; runs on)
                with self._count:
                    self.errors += 1
                    self.first_error = self.first_error or repr(e)
                continue
            self.lat_ms.append((time.perf_counter() - t0) * 1000.0)
            rows = reply.get("results", [])
            if len(rows) != self.batch or any(len(r) != self.k
                                              for r in rows):
                with self._count:
                    self.partial += 1

    def start(self) -> "Clients":
        self._t0 = time.perf_counter()
        for t in self._threads:
            t.start()
        return self

    def finish(self, timeout: float = 120.0) -> dict:
        """Stop, wait for the requests in flight → the window's record."""
        self._stop.set()
        window = time.perf_counter() - self._t0
        for t in self._threads:
            t.join(timeout=timeout)
        return {"lat_ms": list(self.lat_ms), "window_s": window,
                "errors": self.errors, "first_error": self.first_error,
                "partial": self.partial,
                "threads_alive": sum(t.is_alive() for t in self._threads)}


def main() -> int:
    cfg = json.loads(sys.stdin.readline())
    clients = Clients(cfg["url"], cfg["body"], cfg["clients"],
                      cfg["batch"], cfg["k"]).start()
    print(json.dumps({"started": True}), flush=True)
    sys.stdin.readline()  # the stop
    print(json.dumps(clients.finish()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
