"""Minimal asyncio HTTP/1.1 server.

Replaces the reference's akka-http layer (reference: [U] akka-http routes
in data/.../api/EventServer.scala and core/.../workflow/CreateServer.scala).
Deliberately dependency-free: the serving hot path wants a thin, predictable stack (parse → dict → handler
→ JSON) under the p50 target. Supports keep-alive, content-length
bodies, and a tiny router with path parameters (``/events/{id}.json``).
"""

from __future__ import annotations

import asyncio
import json
import logging
import re
import time
import traceback
import urllib.parse
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

from predictionio_tpu_torch.utils import tracing

#: structured access log — one JSON line per request when the server is
#: constructed with ``access_log=True`` (``--access-log``)
access_logger = logging.getLogger("pio.access")

MAX_BODY = 64 * 1024 * 1024
MAX_HEADER = 64 * 1024

# Memoized urlsplit + parse_qs per raw request target. Event-ingest
# clients send the same target string on every keep-alive POST
# (`/events.json?accessKey=...`), so the split/parse cost — ~15% of
# the server-side CPU per request at 5k req/s — is paid once per
# distinct target. Bounded; cleared when full (attacker-chosen targets
# must not grow it without bound).
_TARGET_CACHE: Dict[str, Tuple[str, Dict[str, List[str]]]] = {}
_TARGET_CACHE_MAX = 1024

# Memoized "HTTP/1.1 <status> <reason>\r\nContent-Type: ...\r\n" bytes
_PREFIX_CACHE: Dict[Tuple[int, str], bytes] = {}


def _split_target(target: str) -> Tuple[str, Dict[str, List[str]]]:
    hit = _TARGET_CACHE.get(target)
    if hit is None:
        parsed = urllib.parse.urlsplit(target)
        hit = (parsed.path, urllib.parse.parse_qs(parsed.query))
        if len(_TARGET_CACHE) >= _TARGET_CACHE_MAX:
            _TARGET_CACHE.clear()
        _TARGET_CACHE[target] = hit
    return hit


@dataclass
class Request:
    method: str
    path: str
    query: Dict[str, List[str]]
    headers: Dict[str, str]
    body: bytes
    path_params: Dict[str, str] = field(default_factory=dict)

    def param(self, name: str, default: Optional[str] = None) -> Optional[str]:
        vals = self.query.get(name)
        return vals[0] if vals else default

    def json(self) -> Any:
        if not self.body:
            return None
        return json.loads(self.body)  # loads handles UTF-8 bytes directly


@dataclass
class Response:
    status: int = 200
    body: bytes = b""
    content_type: str = "application/json; charset=utf-8"
    headers: Dict[str, str] = field(default_factory=dict)

    @classmethod
    def json(cls, obj: Any, status: int = 200) -> "Response":
        return cls(status=status,
                   body=json.dumps(obj, separators=(",", ":")).encode("utf-8"))

    @classmethod
    def text(cls, s: str, status: int = 200, content_type: str = "text/plain") -> "Response":
        return cls(status=status, body=s.encode("utf-8"), content_type=content_type)


Handler = Callable[[Request], Awaitable[Response]]


async def traces_handler(req: Request) -> Response:
    """``GET /traces`` — recent spans from the tracer's ring buffer,
    filterable by ``?trace_id=``, ``?min_ms=``, ``?error=1``,
    ``?limit=``. Mounted by both servers."""
    try:
        raw_min = req.param("min_ms")
        min_ms = float(raw_min) if raw_min else None
        limit = int(req.param("limit") or "100")
    except ValueError:
        return Response.json(
            {"message": "min_ms and limit must be numeric"}, status=400)
    errors_only = (req.param("error") or "") in ("1", "true", "yes")
    return Response.json(tracing.traces_payload(
        trace_id=req.param("trace_id"), min_ms=min_ms,
        errors_only=errors_only, limit=max(1, min(limit, 1000))))

_REASONS = {
    200: "OK", 201: "Created", 400: "Bad Request", 401: "Unauthorized",
    403: "Forbidden", 404: "Not Found", 405: "Method Not Allowed",
    413: "Payload Too Large", 429: "Too Many Requests",
    500: "Internal Server Error", 502: "Bad Gateway",
    503: "Service Unavailable", 504: "Gateway Timeout",
}


class Router:
    def __init__(self) -> None:
        # (method, regex, param names, handler)
        self._routes: List[Tuple[str, re.Pattern, Handler]] = []
        # memoized match results — the ingest hot path asks for the
        # same (method, path) on every keep-alive request, so the
        # linear regex scan is paid once per distinct route. Bounded;
        # cleared when full (attacker-chosen paths must not grow it).
        self._match_cache: Dict[Tuple[str, str],
                                Optional[Tuple[Handler, Dict[str, str]]]] = {}

    def route(self, method: str, pattern: str, handler: Handler) -> None:
        """Pattern supports ``{name}`` path params (one segment) and
        ``{name+}`` (greedy, may span slashes).

        Params are substituted BEFORE ``re.escape`` runs on the literal
        parts: escaping first turned ``{path+}`` into ``{path\\+}``,
        which neither substitution matched — every greedy route 404'd
        (caught by the plugin-route tests)."""
        parts = re.split(r"(\{\w+\+?\})", pattern)
        rx = "".join(
            # the capture group alternates literal/param parts: odd
            # indices are params; prefix checks would misread literal
            # brace text (e.g. "{b-c}") as a param and die in compile
            re.escape(p) if i % 2 == 0
            else (r"(?P<%s>.+)" % p[1:-2]) if p.endswith("+}")
            else (r"(?P<%s>[^/]+)" % p[1:-1])
            for i, p in enumerate(parts))
        self._routes.append((method.upper(), re.compile("^" + rx + "$"), handler))
        self._match_cache.clear()

    def match(self, method: str, path: str) -> Optional[Tuple[Handler, Dict[str, str]]]:
        key = (method, path)
        try:
            hit = self._match_cache[key]
        except KeyError:
            pass
        else:
            # path params are per-request mutable state (handlers may
            # pop/own them) — hand out a copy, keep the cached original
            return (hit[0], dict(hit[1])) if hit is not None else None
        found = None
        for m, rx, h in self._routes:
            g = rx.match(path)
            if g and m == method.upper():
                found = (h, g.groupdict())
                break
        if len(self._match_cache) >= 1024:
            self._match_cache.clear()
        self._match_cache[key] = found
        return (found[0], dict(found[1])) if found is not None else None


class HTTPServer:
    def __init__(self, router: Router, host: str = "0.0.0.0", port: int = 8000,
                 ssl_context: Optional[Any] = None,
                 bind_retries: int = 0, bind_retry_sec: float = 1.0,
                 access_log: bool = False,
                 server_name: str = "http") -> None:
        self.router = router
        self.host = host
        self.port = port
        #: one JSON line per request on the ``pio.access`` logger
        self.access_log = access_log
        #: tags the root span so /traces can tell the two servers apart
        self.server_name = server_name
        #: optional ssl.SSLContext (see server.ssl_config) → HTTPS
        self.ssl_context = ssl_context
        #: port-in-use bind retry (the reference's MasterActor retries
        #: the bind while the previous instance shuts down)
        self.bind_retries = bind_retries
        self.bind_retry_sec = bind_retry_sec
        self._server: Optional[asyncio.AbstractServer] = None
        self._shutdown = asyncio.Event()

    async def _read_request(self, reader: asyncio.StreamReader) -> Optional[Request]:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            return None
        if len(head) > MAX_HEADER:
            return None
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, target, _version = lines[0].split(" ", 2)
        except ValueError:
            return None
        headers: Dict[str, str] = {}
        for line in lines[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        try:
            length = int(headers.get("content-length", "0") or "0")
        except ValueError:
            return None
        if length < 0 or length > MAX_BODY:
            return None
        body = await reader.readexactly(length) if length else b""
        # cached (path, query) — treated as read-only by handlers
        path, query = _split_target(target)
        return Request(
            method=method.upper(),
            path=path,
            query=query,
            headers=headers,
            body=body,
        )

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            while not self._shutdown.is_set():
                req = await self._read_request(reader)
                if req is None:
                    break
                resp = await self._dispatch(req)
                keep = req.headers.get("connection", "keep-alive").lower() != "close"
                # status line + Content-Type are memoized per
                # (status, content_type): only lengths and extra
                # headers vary request to request
                pkey = (resp.status, resp.content_type)
                prefix = _PREFIX_CACHE.get(pkey)
                if prefix is None:
                    prefix = (
                        f"HTTP/1.1 {resp.status} "
                        f"{_REASONS.get(resp.status, '')}\r\n"
                        f"Content-Type: {resp.content_type}\r\n"
                    ).encode("latin-1")
                    if len(_PREFIX_CACHE) < 256:
                        _PREFIX_CACHE[pkey] = prefix
                extra = (b"".join(f"{k}: {v}\r\n".encode("latin-1")
                                  for k, v in resp.headers.items())
                         if resp.headers else b"")
                payload = (prefix
                           + b"Content-Length: %d\r\n" % len(resp.body)
                           + extra
                           + (b"Connection: keep-alive\r\n\r\n" if keep
                              else b"Connection: close\r\n\r\n")
                           + resp.body)
                writer.write(payload)
                # flow control only when the transport is actually
                # backed up — drain() on an empty buffer still costs a
                # coroutine round trip per response
                if writer.transport.get_write_buffer_size() > 65536:
                    await writer.drain()
                if not keep:
                    break
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _dispatch(self, req: Request) -> Response:
        """Root span + propagation headers + access log around the
        route. The disabled-everything path falls straight through to
        the router — tracing off must cost nothing measurable."""
        if not tracing.TRACER.enabled and not self.access_log:
            return await self._route(req)
        t0 = time.perf_counter()
        trace_id = ""
        if tracing.TRACER.enabled:
            in_trace, in_parent, in_sampled = tracing.extract_headers(
                req.headers)
            async with tracing.root_span(
                    "http.request", trace_id=in_trace,
                    parent_span_id=in_parent, sampled=in_sampled,
                    server=self.server_name, method=req.method,
                    path=req.path) as sp:
                resp = await self._route(req)
                sp.set_attr("status", resp.status)
                if resp.status >= 500:
                    sp.set_error(f"HTTP {resp.status}")
                trace_id = sp.trace_id
            if trace_id:
                resp.headers["X-PIO-Trace-Id"] = trace_id
        else:
            resp = await self._route(req)
        if self.access_log:
            access_logger.info(json.dumps(
                {"server": self.server_name, "method": req.method,
                 "path": req.path, "status": resp.status,
                 "duration_ms": round((time.perf_counter() - t0) * 1000, 3),
                 "trace_id": trace_id or None},
                separators=(",", ":")))
        return resp

    async def _route(self, req: Request) -> Response:
        found = self.router.match(req.method, req.path)
        if found is None:
            return Response.json({"message": "Not Found"}, status=404)
        handler, params = found
        req.path_params = params
        try:
            return await handler(req)
        except json.JSONDecodeError as e:
            return Response.json({"message": f"invalid JSON: {e}"}, status=400)
        except Exception:
            traceback.print_exc()
            return Response.json({"message": "Internal Server Error"}, status=500)

    async def start(self) -> None:
        import errno

        attempt = 0
        while True:
            try:
                self._server = await asyncio.start_server(
                    self._handle_conn, self.host, self.port,
                    ssl=self.ssl_context)
                return
            except OSError as e:
                if e.errno != errno.EADDRINUSE or attempt >= self.bind_retries:
                    raise
                attempt += 1
                await asyncio.sleep(self.bind_retry_sec)

    @property
    def bound_port(self) -> int:
        """Actual listening port (use with ``port=0`` in tests)."""
        assert self._server is not None
        return self._server.sockets[0].getsockname()[1]

    async def serve_forever(self) -> None:
        await self.start()
        assert self._server is not None
        async with self._server:
            await self._shutdown.wait()

    async def stop(self) -> None:
        self._shutdown.set()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    def request_shutdown(self) -> None:
        self._shutdown.set()
        if self._server is not None:
            self._server.close()
