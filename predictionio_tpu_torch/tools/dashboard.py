"""Dashboard: HTML table of completed evaluation instances on :9000 (the
port's copy of the JAX package's ``tools/dashboard.py``, over the port's
storage). Renders each evaluation instance with status, timing, and
per-candidate scores; JSON at ``/evaluations.json`` for tooling.
"""

from __future__ import annotations

import asyncio
import html
import json
from typing import Optional

from predictionio_tpu_torch.server.http import HTTPServer, Request, Response, Router
from predictionio_tpu_torch.storage.registry import Storage, get_storage

_PAGE = """<!DOCTYPE html>
<html><head><title>predictionio_tpu_torch dashboard</title>
<style>
body {{ font-family: system-ui, sans-serif; margin: 2rem; }}
table {{ border-collapse: collapse; width: 100%; }}
th, td {{ border: 1px solid #ccc; padding: .4rem .6rem; text-align: left;
          vertical-align: top; font-size: .9rem; }}
th {{ background: #f4f4f4; }}
pre {{ margin: 0; white-space: pre-wrap; max-width: 44rem; }}
</style></head>
<body><h1>Evaluation instances</h1>
<table><tr><th>id</th><th>status</th><th>evaluation</th><th>start</th>
<th>end</th><th>results</th></tr>{rows}</table></body></html>
"""


class Dashboard:
    def __init__(self, storage: Optional[Storage] = None,
                 host: str = "0.0.0.0", port: int = 9000) -> None:
        self.storage = storage or get_storage()
        router = Router()
        router.route("GET", "/", self._index)
        router.route("GET", "/evaluations.json", self._json)
        self.http = HTTPServer(router, host, port)

    async def _index(self, req: Request) -> Response:
        rows = []
        for vi in self.storage.meta.list_evaluation_instances():
            rows.append(
                "<tr><td>{}</td><td>{}</td><td>{}</td><td>{}</td><td>{}</td>"
                "<td><pre>{}</pre></td></tr>".format(
                    html.escape(vi.id), html.escape(vi.status),
                    html.escape(vi.evaluation_class),
                    vi.start_time.isoformat(timespec="seconds"),
                    vi.end_time.isoformat(timespec="seconds") if vi.end_time else "—",
                    html.escape(vi.evaluator_results or "")))
        return Response.text(_PAGE.format(rows="".join(rows)),
                             content_type="text/html; charset=utf-8")

    async def _json(self, req: Request) -> Response:
        out = []
        for vi in self.storage.meta.list_evaluation_instances():
            out.append({
                "id": vi.id, "status": vi.status,
                "evaluationClass": vi.evaluation_class,
                "startTime": vi.start_time.isoformat(timespec="milliseconds"),
                "endTime": vi.end_time.isoformat(timespec="milliseconds") if vi.end_time else None,
                "results": vi.evaluator_results,
                "resultsJSON": json.loads(vi.evaluator_results_json) if vi.evaluator_results_json else None,
            })
        return Response.json(out)

    async def serve_forever(self) -> None:
        await self.http.serve_forever()

    def run(self) -> None:
        asyncio.run(self.serve_forever())
