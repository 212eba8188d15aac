"""HTTP JSON API for the search service (port of
theoremsearch_tpu/serve/http_api.py: the same routes, request and
response JSON; a route whose engine feature is not ported yet answers
501).

The reference serves only through Streamlit widgets; a production
deployment needs a programmatic surface. Stdlib-only (no extra deps):

    POST /search   {"query": str, "top_k": int, "citation_weight": float,
                    "filters": {...same keys as the UI dict...}}
    POST /documents         {"documents": [{...meta columns + slogan...}]}
                            -> {"doc_ids": [...]} (live upsert; searchable
                            by the next query)
    POST /documents/delete  {"doc_ids": [...]} -> {"deleted": N}
    GET  /facets   -> {"authors": [...], "tags_per_source": {...},
                       "theorem_count": N}
    GET  /health   -> {"status": "ok", "corpus": N}
    GET  /metrics  -> Prometheus text exposition: request/batch/shed/error
                      counters, inflight + coalesce-held gauges, and
                      latency quantiles from the scheduler (when the
                      service runs one)

Concurrent requests share the card through SearchService; batching across
connections comes from the ThreadingHTTPServer handing vectors to the
engine in whatever concurrency arrives (pair with serve.scheduler for
explicit micro-batching).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..utils.gc_tuning import freeze_permanent
from .app import SearchService, _filters_from_ui
from .scheduler import SchedulerOverloaded


def make_handler(service: SearchService):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload, default=str).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # quiet
            pass

        def _send_metrics(self) -> None:
            lines = [
                "# TYPE theoremsearch_corpus_rows gauge",
                f"theoremsearch_corpus_rows {service.load_theorem_count()}",
            ]
            sched = getattr(service, "scheduler", None)
            if sched is not None:
                s = sched.stats()
                for name, key in (
                    ("requests", "queries"),
                    ("batches", "batches"),
                    ("shed", "shed"),
                    ("errors", "errors"),
                ):
                    lines += [
                        f"# TYPE theoremsearch_{name}_total counter",
                        f"theoremsearch_{name}_total {s[key]}",
                    ]
                lines += [
                    "# TYPE theoremsearch_inflight gauge",
                    f"theoremsearch_inflight {s['inflight']}",
                    "# TYPE theoremsearch_coalesce_held gauge",
                    f"theoremsearch_coalesce_held {s['held']}",
                    "# TYPE theoremsearch_avg_batch gauge",
                    f"theoremsearch_avg_batch {s['avg_batch']:.3f}",
                ]
                lat = s.get("latency_ms") or {}
                if lat:
                    lines.append("# TYPE theoremsearch_latency_ms summary")
                    lines += [
                        f'theoremsearch_latency_ms{{quantile="{q}"}} {v:.3f}'
                        for q, v in lat.items()
                    ]
            body = ("\n".join(lines) + "\n").encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._send(200, {"status": "ok", "corpus": service.load_theorem_count()})
            elif self.path == "/metrics":
                self._send_metrics()
            elif self.path == "/facets":
                self._send(
                    200,
                    {
                        "authors": service.load_authors(),
                        "tags_per_source": service.load_tags_per_source(),
                        "theorem_count": service.load_theorem_count(),
                    },
                )
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                if self.path == "/search":
                    query = req.get("query", "")
                    ui = dict(req.get("filters") or {})
                    if "top_k" in req:
                        ui["top_k"] = req["top_k"]
                    if "citation_weight" in req:
                        ui["citation_weight"] = req["citation_weight"]
                    filters = _filters_from_ui(ui)
                    rows = service.search_and_display(query, filters)
                    self._send(200, {"query": query, "results": rows})
                elif self.path == "/documents":
                    # live upsert: {"documents": [{slogan, theorem_name,
                    # paper_title, year, ...}, ...]} -> assigned doc ids,
                    # searchable by the next query (the reference's
                    # pgvector-upsert visibility)
                    docs = req.get("documents") or []
                    if not isinstance(docs, list) or not docs:
                        self._send(400, {"error": "documents must be a non-empty list"})
                        return
                    ids = service.index_documents(docs)
                    self._send(200, {"doc_ids": ids})
                elif self.path == "/documents/delete":
                    ids = req.get("doc_ids") or []
                    n = service.delete_documents([int(i) for i in ids])
                    self._send(200, {"deleted": n})
                elif self.path == "/feedback":
                    # thumbs up/down persistence (the reference's UI-only
                    # save_feedback stub, streamlit_app.py:145-147, made
                    # a real API)
                    vote = req.get("feedback", req.get("vote", ""))
                    if vote not in ("up", "down"):
                        self._send(400, {"error": "feedback must be 'up' or 'down'"})
                        return
                    saved = service.save_feedback(
                        vote,
                        str(req.get("query", "")),
                        str(req.get("url", "")),
                        str(req.get("theorem_name", "")),
                        text=req.get("text"),
                    )
                    self._send(200, {"saved": saved})
                else:
                    self._send(404, {"error": "not found"})
            except json.JSONDecodeError:
                self._send(400, {"error": "invalid JSON body"})
            except NotImplementedError as e:
                self._send(501, {"error": str(e)[:300]})
            except SchedulerOverloaded as e:
                # admission control: shed load instead of queueing into
                # unbounded tail latency
                self._send(429, {"error": f"overloaded: {e}", "retry_after_ms": 100})
            except Exception as e:  # noqa: BLE001
                self._send(500, {"error": str(e)[:300]})

    return Handler


class _HTTPServer(ThreadingHTTPServer):
    # listen backlog: socketserver's default of 5 resets connections as
    # soon as a few dozen clients connect at once
    request_queue_size = 1024


class SearchServer:
    """Threaded HTTP server wrapper with clean start/stop."""

    def __init__(self, service: SearchService, host: str = "127.0.0.1", port: int = 0):
        self.httpd = _HTTPServer((host, port), make_handler(service))
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> "SearchServer":
        # serving-path GC discipline: the corpus metadata / param graph
        # is permanent — freezing it keeps periodic gen-2 passes from
        # stalling every thread (utils/gc_tuning.py)
        freeze_permanent()
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)

