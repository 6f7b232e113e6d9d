"""Admin server: REST admin API on :7071 (the port's copy of the JAX
package's ``tools/admin.py``, over the port's storage). Routes:

    GET    /                      {"status": "alive"}
    GET    /cmd/app               list apps (+ keys and channels)
    POST   /cmd/app               {"name": ..., "description": ...}
    GET    /cmd/app/{name}        one app
    DELETE /cmd/app/{name}        delete app (meta + access keys; event
                                  data wiped via ?data=true)
    DELETE /cmd/app/{name}/data   wipe the app's event data only
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, Optional

from predictionio_tpu_torch.server.http import HTTPServer, Request, Response, Router
from predictionio_tpu_torch.storage.registry import Storage, get_storage


class AdminServer:
    def __init__(self, storage: Optional[Storage] = None,
                 host: str = "0.0.0.0", port: int = 7071) -> None:
        self.storage = storage or get_storage()
        router = Router()
        router.route("GET", "/", self._status)
        router.route("GET", "/cmd/app", self._list_apps)
        router.route("POST", "/cmd/app", self._create_app)
        router.route("GET", "/cmd/app/{name}", self._get_app)
        router.route("DELETE", "/cmd/app/{name}", self._delete_app)
        router.route("DELETE", "/cmd/app/{name}/data", self._delete_app_data)
        self.http = HTTPServer(router, host, port)

    def _app_json(self, app) -> Dict[str, Any]:
        keys = self.storage.meta.list_access_keys(app.id)
        channels = self.storage.meta.list_channels(app.id)
        return {
            "id": app.id,
            "name": app.name,
            "description": app.description,
            "accessKeys": [
                {"key": k.key, "events": k.events} for k in keys],
            "channels": [{"id": c.id, "name": c.name} for c in channels],
        }

    async def _status(self, req: Request) -> Response:
        return Response.json({"status": "alive"})

    async def _list_apps(self, req: Request) -> Response:
        def run():
            return [self._app_json(a) for a in self.storage.meta.list_apps()]

        return Response.json({"apps": await asyncio.to_thread(run)})

    async def _create_app(self, req: Request) -> Response:
        obj = req.json() or {}
        name = obj.get("name")
        if not name:
            return Response.json({"message": "name is required"}, status=400)
        meta = self.storage.meta

        def run():
            if meta.get_app_by_name(name) is not None:
                return None
            app = meta.create_app(name, obj.get("description", ""))
            key = meta.create_access_key(app.id)
            return {**self._app_json(app), "accessKey": key.key}

        body = await asyncio.to_thread(run)
        if body is None:
            return Response.json(
                {"message": f"app {name!r} already exists"}, status=409)
        return Response.json(body, status=201)

    def _resolve(self, req: Request):
        return self.storage.meta.get_app_by_name(req.path_params["name"])

    async def _get_app(self, req: Request) -> Response:
        def run():
            app = self._resolve(req)
            return self._app_json(app) if app is not None else None

        body = await asyncio.to_thread(run)
        if body is None:
            return Response.json({"message": "app not found"}, status=404)
        return Response.json(body)

    async def _delete_app(self, req: Request) -> Response:
        def run():
            app = self._resolve(req)
            if app is None:
                return None
            if req.param("data", "false") == "true":
                for ch in self.storage.meta.list_channels(app.id):
                    self.storage.events.wipe(app.id, ch.id)
                self.storage.events.wipe(app.id)
            for k in self.storage.meta.list_access_keys(app.id):
                self.storage.meta.delete_access_key(k.key)
            self.storage.meta.delete_app(app.id)
            return app.name

        name = await asyncio.to_thread(run)
        if name is None:
            return Response.json({"message": "app not found"}, status=404)
        return Response.json({"message": f"app {name!r} deleted"})

    async def _delete_app_data(self, req: Request) -> Response:
        def run():
            app = self._resolve(req)
            if app is None:
                return None
            for ch in self.storage.meta.list_channels(app.id):
                self.storage.events.wipe(app.id, ch.id)
            self.storage.events.wipe(app.id)
            return app.name

        name = await asyncio.to_thread(run)
        if name is None:
            return Response.json({"message": "app not found"}, status=404)
        return Response.json({"message": f"data for app {name!r} deleted"})

    async def serve_forever(self) -> None:
        await self.http.serve_forever()

    def run(self) -> None:
        asyncio.run(self.serve_forever())
