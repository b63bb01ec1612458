"""HTTP serving: the online face of :class:`ance_tpu_torch.serve.Retriever`.

Counterpart of ``ance_tpu/serve_http.py``, with the same JSON API (stdlib
``http.server`` only):

  GET  /healthz   → {"status": "ok", "ntotal": N, "pid_space": ..., ...}
  GET  /metrics   → {"requests", "queries", "errors", "reloads",
                     "latency_ms_ewma", "lock_wait_ms_total"}; lock_wait is
                     time requests spent queued on the device lock
  POST /search    {"queries": ["text", ...], "k": 10} or
                  {"ids": [[...]], "mask": [[...]], "k": 10}
                  → {"results": [[{"pid", "score"}, ...]], "k", "latency_ms"}
  POST /reload    {"index": "/path/saved_index"[, "gap": true]} — hot-swap a
                  saved flat or IVF index (+ its .ids.npy sidecar) under
                  the device lock; only with ``allow_reload=True``. Hot mode holds both
                  indexes on the device for a moment; gap mode frees the old
                  one first and searches queue during the load.

Device work is serialized with a lock (one card, one batch in flight); the
HTTP threads overlap only host-side parsing and tokenization.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

MAX_BODY_BYTES = 64 * 1024 * 1024


class RetrieverHTTPServer:
    """Wraps a Retriever in a ThreadingHTTPServer. ``serve_forever``
    blocks (CLI use); ``start``/``shutdown`` run it on a daemon thread."""

    def __init__(self, retriever, host: str = "127.0.0.1", port: int = 8080,
                 pid_space: str = "real", default_k: int = 10,
                 max_k: int = 1000, max_batch: int = 4096,
                 pad_token_id: Optional[int] = None,
                 allow_reload: bool = False):
        self.retriever = retriever
        self.pid_space = pid_space
        self.default_k = default_k
        # an operator --topk above max_k must not 400 every defaulted request
        self.max_k = max(max_k, default_k)
        self.max_batch = max_batch
        # the model's pad id wins over the tokenizer's: RoBERTa pads with 1,
        # and 0 is its CLS token
        if pad_token_id is not None:
            self.pad_token_id = pad_token_id
        else:
            self.pad_token_id = getattr(retriever.tokenizer,
                                        "pad_token_id", 0) or 0
        self.allow_reload = allow_reload
        # where a reloaded index goes and the dim it must have; kept apart
        # from the live index, which a failed gap reload leaves unset
        self._index_device = retriever.index.device
        self._index_dim = retriever.index.dim
        self._device_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stats = {"requests": 0, "queries": 0, "errors": 0,
                       "reloads": 0, "latency_ms_ewma": 0.0,
                       "lock_wait_ms_total": 0.0}
        self._stats_lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # bound every socket read: a client that stops mid-body must not
            # park a handler thread forever
            timeout = 60

            def log_message(self, fmt, *fmt_args):
                pass

            def _reply(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    if self.path == "/healthz":
                        return self._reply(200, {
                            "status": "ok",
                            "ntotal": int(outer.retriever.index.ntotal),
                            "pid_space": outer.pid_space,
                            "max_k": outer.max_k,
                            "max_batch": outer.max_batch,
                        })
                    if self.path == "/metrics":
                        with outer._stats_lock:
                            return self._reply(200, dict(
                                outer._stats,
                                latency_ms_ewma=round(
                                    outer._stats["latency_ms_ewma"], 2)))
                    self._reply(404, {"error": "unknown path"})
                except Exception as e:  # the server keeps answering
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

            def do_POST(self):
                if self.path not in ("/search", "/reload"):
                    return self._reply(404, {"error": "unknown path"})
                outer._count(requests=1)  # errors/requests is a valid rate
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    if n > MAX_BODY_BYTES:
                        outer._count(errors=1)
                        return self._reply(413, {"error": "body too large"})
                    req = json.loads(self.rfile.read(n))
                except ValueError as e:  # JSONDecodeError is a ValueError
                    outer._count(errors=1)
                    return self._reply(400, {"error": f"bad json: {e}"})
                except OSError:
                    # read timed out or the socket died: free the thread
                    outer._count(errors=1)
                    self.close_connection = True
                    try:
                        return self._reply(408, {"error": "request timeout"})
                    except OSError:
                        return
                try:
                    payload = outer._reload(req) if self.path == "/reload" \
                        else outer._search(req)
                except _BadRequest as e:
                    outer._count(errors=1)
                    return self._reply(400, {"error": str(e)})
                except Exception as e:  # device or tokenizer failure
                    outer._count(errors=1)
                    return self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                self._reply(200, payload)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True

    @property
    def address(self) -> tuple[str, int]:
        return self._server.server_address[:2]

    def _count(self, requests: int = 0, queries: int = 0, errors: int = 0,
               reloads: int = 0, latency_ms: Optional[float] = None,
               lock_wait_ms: float = 0.0) -> None:
        with self._stats_lock:
            self._stats["requests"] += requests
            self._stats["queries"] += queries
            self._stats["errors"] += errors
            self._stats["reloads"] += reloads
            self._stats["lock_wait_ms_total"] += lock_wait_ms
            if latency_ms is not None:
                prev = self._stats["latency_ms_ewma"]
                self._stats["latency_ms_ewma"] = latency_ms if prev == 0 \
                    else 0.9 * prev + 0.1 * latency_ms

    @contextlib.contextmanager
    def _locked_device(self):
        """The device lock; time spent waiting for it goes to
        lock_wait_ms_total."""
        t0 = time.perf_counter()
        with self._device_lock:
            self._count(lock_wait_ms=(time.perf_counter() - t0) * 1000.0)
            yield

    def _reload(self, req: dict) -> dict:
        """Hot-swap a saved index (the serve CLI's --save_index artifact,
        flat or IVF by the file's own keys, ids in real pid space) onto the
        live index's device."""
        if not self.allow_reload:
            raise _BadRequest("reload disabled on this server")
        if not isinstance(req, dict) or not isinstance(req.get("index"), str):
            raise _BadRequest("need {'index': '/path/to/saved_index'}")
        from ance_tpu_torch.index.flat import FlatIPIndex
        from ance_tpu_torch.index.ivf import IVFIPIndex
        path = req["index"]
        old = self.retriever.index
        device, old_dim = self._index_device, self._index_dim
        lp = path if path.endswith(".npz") else path + ".npz"
        sidecar = (path[:-len(".npz")] if path.endswith(".npz") else path
                   ) + ".ids.npy"
        try:
            with np.load(lp, allow_pickle=False) as z:
                is_ivf = "bins_emb" in z.files
                saved_n = int(z["ntotal"]) if "ntotal" in z.files else None
            e2id = np.load(sidecar).astype(np.int64)
            if saved_n is not None and len(e2id) != saved_n:
                raise _BadRequest(
                    "saved index and its .ids.npy sidecar disagree")

            def load_new():
                idx = (IVFIPIndex if is_ivf else FlatIPIndex).load(
                    lp, device=device)
                if idx.dim != old_dim:
                    raise _BadRequest(
                        f"index dim {idx.dim} != encoder dim {old_dim}")
                if len(e2id) != idx.ntotal:
                    raise _BadRequest(
                        "saved index and its .ids.npy sidecar disagree")
                return idx

            if req.get("gap"):
                with self._locked_device():
                    self.retriever.index = None  # free before loading
                    del old
                    new_index = load_new()
                    self.retriever.index = new_index
                    self.retriever.embedding2id = e2id
                    self.pid_space = "real"
            else:
                new_index = load_new()
                with self._locked_device():
                    self.retriever.index = new_index
                    self.retriever.embedding2id = e2id
                    self.pid_space = "real"  # the sidecar holds real pids
        except _BadRequest:
            raise
        except (OSError, ValueError, KeyError) as e:
            raise _BadRequest(f"cannot load index {path!r}: {e}")
        self._count(reloads=1)
        return {"reloaded": path, "kind": "ivf" if is_ivf else "flat",
                "ntotal": int(new_index.ntotal)}

    def _search(self, req: dict) -> dict:
        if not isinstance(req, dict):
            raise _BadRequest("body must be a JSON object")
        k = req.get("k", self.default_k)
        # bool is a subclass of int: {"k": true} must not mean k=1
        if isinstance(k, bool) or not isinstance(k, int) \
                or not 1 <= k <= self.max_k:
            raise _BadRequest(f"k must be an int in [1, {self.max_k}]")
        t0 = time.perf_counter()
        if "queries" in req:
            queries = req["queries"]
            if (not isinstance(queries, list) or not queries
                    or not all(isinstance(q, str) for q in queries)):
                raise _BadRequest("queries must be a non-empty list of strings")
            if len(queries) > self.max_batch:
                raise _BadRequest(f"batch > max_batch ({self.max_batch})")
            if self.retriever.tokenizer is None:
                raise _BadRequest("server has no tokenizer; POST token "
                                  "arrays as ids/mask instead")
            ids, mask = self.retriever.tokenize_queries(queries)  # no lock
        elif "ids" in req:
            try:
                ids = np.asarray(req["ids"], np.int32)
                if "mask" in req:
                    mask = np.asarray(req["mask"], np.int32)
                else:
                    mask = (ids != self.pad_token_id).astype(np.int32)
            except (ValueError, TypeError) as e:
                raise _BadRequest(f"bad ids/mask arrays: {e}")
            if ids.ndim != 2 or mask.shape != ids.shape:
                raise _BadRequest("ids/mask must be equal-shape 2-D arrays")
            if len(ids) > self.max_batch:
                raise _BadRequest(f"batch > max_batch ({self.max_batch})")
        else:
            raise _BadRequest("need 'queries' (text) or 'ids' (+'mask')")
        # bucket the batch width to a power of two (padding rows repeat row
        # 0 and are stripped): a bounded set of shapes reaches the device
        from ance_tpu_torch.serve import bucket_pow2
        B = len(ids)
        pad = bucket_pow2(B, self.max_batch) - B
        if pad:
            ids = np.concatenate([ids, np.repeat(ids[:1], pad, 0)], axis=0)
            mask = np.concatenate([mask, np.repeat(mask[:1], pad, 0)],
                                  axis=0)
        with self._locked_device():
            scores, pids = self.retriever.search_tokens(ids, mask, k)
        scores, pids = np.asarray(scores)[:B], np.asarray(pids)[:B]
        ms = (time.perf_counter() - t0) * 1000.0
        self._count(queries=int(pids.shape[0]), latency_ms=ms)
        results = [[{"pid": int(p), "score": float(s)}
                    for p, s in zip(prow, srow) if p >= 0]
                   for prow, srow in zip(pids, scores)]
        return {"results": results, "k": k, "latency_ms": round(ms, 2)}

    def serve_forever(self) -> None:
        self._server.serve_forever()

    def start(self) -> "RetrieverHTTPServer":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


class _BadRequest(ValueError):
    pass
