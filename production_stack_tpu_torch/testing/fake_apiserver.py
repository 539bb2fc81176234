"""Fake Kubernetes apiserver for operator tests.

The port's copy of ``production_stack_tpu/testing/fake_apiserver.py``
(pure aiohttp; it imports neither the JAX package nor torch).

In-memory implementation of the REST subset the C++ operator uses:
list/get/create/update/delete on namespaced resources (any group), the
``/status`` subresource, labelSelector filtering, and a line-delimited watch.
This is the stack's envtest analogue (reference: operator
suite_test.go:31-88 spins a real kube-apiserver via envtest; we fake it —
same test purpose, zero cluster).
"""

from __future__ import annotations

import argparse
import asyncio
import itertools
import json
import re
from typing import Optional

from aiohttp import web

_COUNTER = itertools.count(1)


class FakeAPIServer:
    def __init__(self):
        # store[(group, version, ns, plural)][name] = object
        self.store: dict[tuple, dict[str, dict]] = {}
        self.watchers: list[tuple[tuple, asyncio.Queue]] = []

    # -- helpers --------------------------------------------------------------

    @staticmethod
    def _key(group: str, version: str, ns: str, plural: str) -> tuple:
        return (group, version, ns, plural)

    def _notify(self, key: tuple, etype: str, obj: dict) -> None:
        for wkey, q in self.watchers:
            if wkey == key:
                q.put_nowait({"type": etype, "object": obj})

    @staticmethod
    def _match_selector(obj: dict, selector: Optional[str]) -> bool:
        if not selector:
            return True
        labels = obj.get("metadata", {}).get("labels", {}) or {}
        for clause in selector.split(","):
            if "=" in clause:
                k, v = clause.split("=", 1)
                if labels.get(k.strip()) != v.strip():
                    return False
        return True

    # -- handlers -------------------------------------------------------------

    async def handle(self, request: web.Request) -> web.StreamResponse:
        m = re.match(
            r"^/(?:apis/(?P<group>[^/]+)/|api/)(?P<version>[^/]+)"
            r"(?:/namespaces/(?P<ns>[^/]+))?/(?P<plural>[^/]+)"
            r"(?:/(?P<name>[^/]+))?(?:/(?P<sub>status))?$",
            request.path,
        )
        if not m:
            return web.json_response({"kind": "Status", "code": 404}, status=404)
        group = m.group("group") or ""
        key = self._key(group, m.group("version"), m.group("ns") or "", m.group("plural"))
        name, sub = m.group("name"), m.group("sub")
        coll = self.store.setdefault(key, {})

        if request.method == "GET" and name is None:
            if request.query.get("watch") in ("true", "1"):
                return await self._watch(request, key)
            selector = request.query.get("labelSelector")
            items = [o for o in coll.values() if self._match_selector(o, selector)]
            return web.json_response(
                {
                    "kind": "List",
                    "apiVersion": "v1",
                    "metadata": {"resourceVersion": str(next(_COUNTER))},
                    "items": items,
                }
            )
        if request.method == "GET":
            obj = coll.get(name)
            if obj is None:
                return web.json_response({"kind": "Status", "code": 404}, status=404)
            return web.json_response(obj)
        if request.method == "POST":
            obj = await request.json()
            oname = obj.get("metadata", {}).get("name")
            if not oname:
                return web.json_response({"error": "no name"}, status=400)
            if oname in coll:
                return web.json_response({"kind": "Status", "code": 409}, status=409)
            obj.setdefault("metadata", {})["uid"] = f"uid-{next(_COUNTER)}"
            obj["metadata"]["resourceVersion"] = str(next(_COUNTER))
            coll[oname] = obj
            self._notify(key, "ADDED", obj)
            return web.json_response(obj, status=201)
        if request.method == "PUT":
            obj = await request.json()
            if name not in coll:
                return web.json_response({"kind": "Status", "code": 404}, status=404)
            if sub == "status":
                coll[name]["status"] = obj.get("status", {})
                coll[name]["metadata"]["resourceVersion"] = str(next(_COUNTER))
                return web.json_response(coll[name])
            obj.setdefault("metadata", {})["uid"] = coll[name]["metadata"].get("uid")
            obj["metadata"]["resourceVersion"] = str(next(_COUNTER))
            # deletionTimestamp is apiserver-owned: carry it across updates
            prior_dts = coll[name]["metadata"].get("deletionTimestamp")
            if prior_dts and "deletionTimestamp" not in obj["metadata"]:
                obj["metadata"]["deletionTimestamp"] = prior_dts
            # preserve status across spec updates (K8s semantics)
            if "status" in coll[name] and "status" not in obj:
                obj["status"] = coll[name]["status"]
            # a terminating object whose last finalizer was removed goes away
            # (K8s finalizer semantics — what the real apiserver does when a
            # controller finishes cleanup and clears its finalizer)
            if obj["metadata"].get("deletionTimestamp") and not obj[
                "metadata"
            ].get("finalizers"):
                coll.pop(name, None)
                self._notify(key, "DELETED", obj)
                return web.json_response(obj)
            coll[name] = obj
            self._notify(key, "MODIFIED", obj)
            return web.json_response(obj)
        if request.method == "DELETE":
            obj = coll.get(name)
            if obj is None:
                return web.json_response({"kind": "Status", "code": 404}, status=404)
            if obj.get("metadata", {}).get("finalizers"):
                # finalizer semantics: mark terminating, keep the object until
                # a controller clears its finalizer (K8s graceful deletion)
                if not obj["metadata"].get("deletionTimestamp"):
                    obj["metadata"]["deletionTimestamp"] = "2026-01-01T00:00:00Z"
                    obj["metadata"]["resourceVersion"] = str(next(_COUNTER))
                    self._notify(key, "MODIFIED", obj)
                return web.json_response(obj)
            coll.pop(name, None)
            self._notify(key, "DELETED", obj)
            return web.json_response({"kind": "Status", "code": 200})
        return web.json_response({"kind": "Status", "code": 405}, status=405)

    async def _watch(self, request: web.Request, key: tuple) -> web.StreamResponse:
        resp = web.StreamResponse(
            headers={"Content-Type": "application/json", "Transfer-Encoding": "chunked"}
        )
        await resp.prepare(request)
        q: asyncio.Queue = asyncio.Queue()
        self.watchers.append((key, q))
        try:
            while True:
                event = await q.get()
                await resp.write((json.dumps(event) + "\n").encode())
        except (ConnectionResetError, asyncio.CancelledError):
            pass
        finally:
            self.watchers.remove((key, q))
        return resp


def make_app() -> tuple[web.Application, FakeAPIServer]:
    srv = FakeAPIServer()
    app = web.Application()
    app.router.add_route("*", "/{tail:.*}", srv.handle)
    return app, srv


def main():
    p = argparse.ArgumentParser("fake-apiserver")
    p.add_argument("--port", type=int, required=True)
    args = p.parse_args()
    app, _ = make_app()
    web.run_app(app, port=args.port, print=None)


if __name__ == "__main__":
    main()
