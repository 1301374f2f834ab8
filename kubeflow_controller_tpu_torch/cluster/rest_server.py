"""Apiserver-style REST facade over a cluster.

Serves the same resource model a real Kubernetes apiserver would —
``/api/v1/namespaces/{ns}/pods[/{name}]``,
``/apis/tpu.kubeflow.dev/v1alpha1/namespaces/{ns}/tpujobs[/{name}]`` — over
an in-process FakeCluster. Together with ``rest_client.RestClusterClient``
this closes the loop the reference ran against a real apiserver
(``docs/development.md:24-41`` there): client and server speak genuine HTTP
over a socket, resourceVersion conflicts surface as 409s, label selectors
filter server-side. Deploying against a real cluster means pointing the
client at a real apiserver URL (plus auth) — the protocol shape is the same.

Counterpart of ``kubeflow_controller_tpu/cluster/rest_server.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""

from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from kubeflow_controller_tpu_torch.api.serialization import (
    job_from_dict, job_to_dict, pod_from_dict, pod_to_dict,
    service_from_dict, service_to_dict,
)
from kubeflow_controller_tpu_torch.cluster.cluster import FakeCluster
from kubeflow_controller_tpu_torch.cluster.store import (
    AlreadyExists, Conflict, NotFound,
)

POD_RE = re.compile(r"^/api/v1/namespaces/([^/]+)/pods(?:/([^/]+))?$")
SVC_RE = re.compile(r"^/api/v1/namespaces/([^/]+)/services(?:/([^/]+))?$")
JOB_RE = re.compile(
    r"^/apis/tpu\.kubeflow\.dev/v1alpha1/namespaces/([^/]+)/tpujobs"
    r"(?:/([^/]+))?$"
)
# Strict-k8s-mode routes: the CRD status subresource, core/v1 Events, and
# GKE-shaped TPU Nodes (the slice pool expressed the way a real cluster
# exposes it).
JOB_STATUS_RE = re.compile(
    r"^/apis/tpu\.kubeflow\.dev/v1alpha1/namespaces/([^/]+)/tpujobs"
    r"/([^/]+)/status$"
)
K8S_EVENTS_RE = re.compile(r"^/api/v1/namespaces/([^/]+)/events$")
K8S_EVENT_ITEM_RE = re.compile(r"^/api/v1/namespaces/([^/]+)/events/([^/]+)$")
NODES_PATH = "/api/v1/nodes"
EVENT_PATH = "/framework/v1/events"
SLICES_RE = re.compile(r"^/framework/v1/slices/([^/]+)$")


def _parse_query(query: str) -> Dict[str, str]:
    import urllib.parse

    out: Dict[str, str] = {}
    for part in (query or "").split("&"):
        if "=" in part:
            k, _, v = part.partition("=")
            out[k] = urllib.parse.unquote(v)
    return out


def _parse_selector(query: str) -> Optional[Dict[str, str]]:
    sel, _ = _parse_selector_full(query)
    return sel


def _parse_selector_full(query: str):
    """Equality selector dict + existence-only keys (``labelSelector=key``
    with no ``=``, which real clients use to scope by label presence)."""
    raw = _parse_query(query).get("labelSelector")
    if not raw:
        return None, ()
    sel: Dict[str, str] = {}
    exists = []
    for kv in raw.split(","):
        if "=" in kv:
            k, _, v = kv.partition("=")
            sel[k] = v
        elif kv:
            exists.append(kv)
    return (sel or None), tuple(exists)


class _WatchRegistry:
    """Active watch queues, so server shutdown can wake and close them."""

    CLOSE = object()

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._queues: set = set()
        self.closing = False

    def register(self, q) -> bool:
        with self._lock:
            if self.closing:
                return False
            self._queues.add(q)
            return True

    def deregister(self, q) -> None:
        with self._lock:
            self._queues.discard(q)

    def close_all(self) -> None:
        with self._lock:
            self.closing = True
            queues = list(self._queues)
        for q in queues:
            q.put(self.CLOSE)


def make_rest_handler(
    cluster: FakeCluster, watches: _WatchRegistry, k8s_mode: bool = False,
):
    """Build the request handler.

    ``k8s_mode=True`` is the strict-Kubernetes facade: genuine core/v1 /
    CRD wire JSON (``kube_wire``), k8s List envelopes with a collection
    resourceVersion, the real watch protocol (``resourceVersion=N`` resume,
    k8s BOOKMARK frames, no framework SYNC marker), the TPUJob **status
    subresource** (main PUT ignores status; ``/status`` PUT applies only
    status), core/v1 Events, and GKE-shaped TPU Nodes synthesized from the
    slice pool. This is the hermetic twin of a real apiserver that
    ``kube_client.KubeClusterClient`` drives — the same client config
    pointed at a real cluster needs no code change.
    """
    from kubeflow_controller_tpu_torch.cluster import kube_wire

    if k8s_mode:
        stores = {
            "pods": (cluster.pods, kube_wire.pod_to_k8s,
                     kube_wire.pod_from_k8s),
            "services": (cluster.services, kube_wire.service_to_k8s,
                         kube_wire.service_from_k8s),
            "jobs": (cluster.jobs, kube_wire.job_to_k8s,
                     kube_wire.job_from_k8s),
        }
    else:
        stores = {
            "pods": (cluster.pods, pod_to_dict, pod_from_dict),
            "services": (cluster.services, service_to_dict, service_from_dict),
            "jobs": (cluster.jobs, job_to_dict, job_from_dict),
        }
    list_envelopes = {
        "pods": ("v1", "PodList"),
        "services": ("v1", "ServiceList"),
        "jobs": (kube_wire.JOB_API_VERSION, "TPUJobList"),
    }
    watch_kinds = {"pods": "Pod", "services": "Service", "jobs": "TPUJob"}

    # Named core/v1 Event objects (strict-k8s mode): a real apiserver
    # materializes POSTed events as addressable objects that the client's
    # aggregating recorder PATCHes (count/lastTimestamp) on repeats.
    k8s_events: Dict[Tuple[str, str], Dict[str, Any]] = {}
    k8s_events_lock = threading.Lock()
    k8s_event_seq = [0]

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code: int, payload: Any) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> Dict:
            n = int(self.headers.get("Content-Length") or 0)
            return json.loads(self.rfile.read(n)) if n else {}

        def _match(self) -> Optional[Tuple[str, str, Optional[str], str]]:
            path, _, query = self.path.partition("?")
            for kind, rx in (("pods", POD_RE), ("services", SVC_RE),
                             ("jobs", JOB_RE)):
                m = rx.match(path)
                if m:
                    return kind, m.group(1), m.group(2), query
            return None

        def _handle(self, method: str) -> None:
            path = self.path.partition("?")[0]
            try:
                if path == EVENT_PATH and method == "POST":
                    b = self._body()
                    cluster.record_event(
                        b["kind"], b["name"], b["reason"], b["message"],
                        namespace=b.get("namespace", ""),
                    )
                    return self._send(200, {"ok": True})
                if k8s_mode and self._handle_k8s(method, path):
                    return
                m = SLICES_RE.match(path)
                if m:
                    uid = m.group(1)
                    if method == "DELETE":
                        return self._send(
                            200, {"released": cluster.slice_pool.release(uid)}
                        )
                    if method == "GET":
                        from kubeflow_controller_tpu_torch.cluster.slices import (
                            slice_to_dict,
                        )

                        return self._send(200, {"items": [
                            slice_to_dict(s)
                            for s in cluster.slice_pool.holdings(uid)
                        ]})
                matched = self._match()
                if matched is None:
                    return self._send(404, {"error": f"no route {path}"})
                kind, ns, name, query = matched
                store, to_dict, from_dict = stores[kind]
                if method == "GET" and name is None:
                    sel, exists = _parse_selector_full(query)
                    q = _parse_query(query)
                    if q.get("watch") in ("true", "1"):
                        return self._watch(
                            store, to_dict, ns, sel, q, kind, exists
                        )
                    items = store.list(ns, sel)
                    if exists:
                        items = [
                            o for o in items
                            if all(k in o.metadata.labels for k in exists)
                        ]
                    if k8s_mode:
                        api_version, list_kind = list_envelopes[kind]
                        return self._send(200, {
                            "apiVersion": api_version,
                            "kind": list_kind,
                            "metadata": {
                                "resourceVersion": str(store.revision),
                            },
                            "items": [to_dict(o) for o in items],
                        })
                    return self._send(200, {
                        "items": [to_dict(o) for o in items]
                    })
                if method == "GET":
                    return self._send(200, to_dict(store.get(ns, name)))
                if method == "POST":
                    obj = from_dict(self._body())
                    return self._send(201, to_dict(store.create(obj)))
                if method == "PUT":
                    obj = from_dict(self._body())
                    if k8s_mode and kind == "jobs":
                        # Status subresource semantics: the main resource
                        # PUT cannot touch .status (apiextensions behavior
                        # once `subresources.status` is registered).
                        stored = store.try_get(ns, name)
                        if stored is not None:
                            obj.status = stored.status
                    return self._send(200, to_dict(store.update(obj)))
                if method == "DELETE":
                    store.delete(ns, name)
                    return self._send(200, {"deleted": f"{ns}/{name}"})
                if method == "PATCH" and k8s_mode:
                    # JSON merge-patch of metadata — the conflict-free
                    # adoption write (no resourceVersion precondition; a
                    # real apiserver applies patches against the live
                    # object the same way). store.mutate is atomic, so a
                    # concurrent status PUT can interleave but never
                    # conflict the patch.
                    pm = (self._body().get("metadata") or {})

                    def apply_meta(o):
                        if "labels" in pm:
                            for k, v in (pm["labels"] or {}).items():
                                if v is None:
                                    o.metadata.labels.pop(k, None)
                                else:
                                    o.metadata.labels[k] = str(v)
                        if "annotations" in pm:
                            for k, v in (pm["annotations"] or {}).items():
                                if v is None:
                                    o.metadata.annotations.pop(k, None)
                                else:
                                    o.metadata.annotations[k] = str(v)
                        if "ownerReferences" in pm:
                            # Lists replace wholesale under merge-patch.
                            parsed = kube_wire.meta_from_k8s(
                                {"ownerReferences": pm["ownerReferences"]}
                            )
                            o.metadata.owner_references = (
                                parsed.owner_references
                            )

                    out = store.mutate(ns, name, apply_meta)
                    return self._send(200, to_dict(out))
                self._send(405, {"error": method})
            except NotFound as e:
                self._send(404, {"error": str(e)})
            except AlreadyExists as e:
                self._send(409, {"error": str(e), "reason": "AlreadyExists"})
            except Conflict as e:
                self._send(409, {"error": str(e), "reason": "Conflict"})
            except Exception as e:
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def _handle_k8s(self, method: str, path: str) -> bool:
            """Strict-k8s-only routes. Returns True if the request was
            handled (response already sent)."""
            m = JOB_STATUS_RE.match(path)
            if m and method == "PUT":
                ns, name = m.group(1), m.group(2)
                incoming = kube_wire.job_from_k8s(self._body())
                # Apply ONLY .status, under the caller's resourceVersion —
                # store.update_status enforces the optimistic-concurrency
                # check and structurally shares the stored frozen spec
                # (no whole-job copy on the status write path).
                out = cluster.jobs.update_status(incoming)
                self._send(200, kube_wire.job_to_k8s(out))
                return True
            m = K8S_EVENTS_RE.match(path)
            if m:
                ns = m.group(1)
                if method == "POST":
                    b = self._body()
                    inv = b.get("involvedObject") or {}
                    # A real apiserver rejects an Event whose namespace
                    # differs from involvedObject.namespace.
                    if (inv.get("namespace") or ns) != ns:
                        self._send(400, {
                            "error": "event namespace does not match "
                                     "involvedObject.namespace",
                            "reason": "BadRequest",
                        })
                        return True
                    meta = b.setdefault("metadata", {})
                    if not meta.get("name"):
                        with k8s_events_lock:
                            k8s_event_seq[0] += 1
                            meta["name"] = (
                                f"{meta.get('generateName', 'event.')}"
                                f"{k8s_event_seq[0]:08x}"
                            )
                    meta["namespace"] = ns
                    with k8s_events_lock:
                        k8s_events[(ns, meta["name"])] = b
                    cluster.record_event(
                        inv.get("kind", ""), inv.get("name", ""),
                        b.get("reason", ""), b.get("message", ""),
                        namespace=ns,
                    )
                    self._send(201, b)
                    return True
                if method == "GET":
                    with k8s_events_lock:
                        items = [
                            dict(v) for (ens, _), v in k8s_events.items()
                            if ens == ns
                        ]
                    self._send(200, {
                        "apiVersion": "v1", "kind": "EventList",
                        "metadata": {"resourceVersion": "0"},
                        "items": items,
                    })
                    return True
            m = K8S_EVENT_ITEM_RE.match(path)
            if m and method == "PATCH":
                ns, name = m.group(1), m.group(2)
                patch = self._body()
                with k8s_events_lock:
                    ev = k8s_events.get((ns, name))
                    if ev is None:
                        self._send(404, {"error": f"event {ns}/{name}",
                                         "reason": "NotFound"})
                        return True
                    # merge-patch semantics for the scalar fields the
                    # aggregating recorder updates.
                    for field in ("count", "lastTimestamp", "message"):
                        if field in patch:
                            ev[field] = patch[field]
                    inv = ev.get("involvedObject") or {}
                    out = dict(ev)
                # Keep the fake cluster's aggregate view in step.
                cluster.record_event(
                    inv.get("kind", ""), inv.get("name", ""),
                    out.get("reason", ""), out.get("message", ""),
                    namespace=ns,
                )
                self._send(200, out)
                return True
            if path == NODES_PATH and method == "GET":
                from kubeflow_controller_tpu_torch.api.topology import (
                    gke_accelerator,
                )

                nodes = []
                for s in cluster.slice_pool.list():
                    for host in s.hosts:
                        nodes.append(kube_wire.node_to_k8s(
                            host, pool=s.name,
                            accelerator=gke_accelerator(s.shape),
                            topology=s.shape.topology_str,
                            ready=s.healthy,
                        ))
                self._send(200, {
                    "apiVersion": "v1", "kind": "NodeList",
                    "metadata": {"resourceVersion": "0"},
                    "items": nodes,
                })
                return True
            return False

        def _watch(
            self, store, to_dict, ns, sel, q, kind=None, exists=(),
        ) -> None:
            """``?watch=true``: stream newline-delimited JSON watch events.

            The k8s chunked-watch analog (the verb the reference's informers
            are built on, ``vendor/.../informers/.../tfjob.go:56``). Always
            list+watch in one stream: replay current objects as ADDED, send a
            SYNC marker, then follow live mutations. BOOKMARK heartbeats keep
            the client's read timeout from firing on idle streams;
            ``timeoutSeconds`` closes the stream server-side (the client
            re-watches — standard watch-expiry behavior).
            """
            import queue

            from kubeflow_controller_tpu_torch.cluster.events import EventType

            timeout_s = float(q.get("timeoutSeconds") or 0)
            heartbeat_s = float(q.get("heartbeatSeconds") or 5)
            # k8s watch resume point: replayed objects at or below this
            # resourceVersion were already in the caller's List response.
            from_rv = int(q.get("resourceVersion") or 0) if k8s_mode else 0
            if k8s_mode and from_rv and store.last_delete_revision > from_rv:
                # A delete happened after the caller's List; with no event
                # history it cannot be replayed — real apiservers answer
                # 410 Gone when the watch cache can't serve an RV, and the
                # client relists.
                return self._send(410, {
                    "kind": "Status", "apiVersion": "v1",
                    "status": "Failure", "reason": "Expired",
                    "message": f"too old resource version: {from_rv}",
                    "code": 410,
                })
            in_replay = True
            deadline = (time.monotonic() + timeout_s) if timeout_s else None
            events: "queue.Queue" = queue.Queue()
            if not watches.register(events):
                return self._send(503, {"error": "server shutting down"})
            store.subscribe(events.put, replay=True)  # replay lands in queue
            events.put(None)  # SYNC marker: replay complete
            try:
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                while True:
                    budget = heartbeat_s
                    if deadline is not None:
                        budget = min(budget, deadline - time.monotonic())
                        if budget <= 0:
                            return
                    try:
                        ev = events.get(timeout=budget)
                    except queue.Empty:
                        if deadline is not None and time.monotonic() >= deadline:
                            return
                        if k8s_mode:
                            api_version, _ = list_envelopes[kind]
                            self._stream_line({
                                "type": "BOOKMARK",
                                "object": {
                                    "apiVersion": api_version,
                                    "kind": watch_kinds[kind],
                                    "metadata": {
                                        "resourceVersion":
                                            str(store.revision),
                                    },
                                },
                            })
                        else:
                            self._stream_line({"type": "BOOKMARK"})
                        continue
                    if ev is _WatchRegistry.CLOSE:
                        return  # server stopping: drop the stream
                    if ev is None:
                        in_replay = False
                        if not k8s_mode:
                            # k8s has no SYNC frame: the client's List
                            # already was the sync point.
                            self._stream_line({"type": "SYNC"})
                        continue
                    obj = ev.obj
                    if (
                        k8s_mode and in_replay
                        and ev.type != EventType.DELETED
                        and obj.metadata.resource_version <= from_rv
                    ):
                        # Caller's List already contained this object.
                        # DELETED is exempt: a delete event carries the
                        # object's LAST resourceVersion (possibly older
                        # than the List) and suppressing it would leave
                        # the client a phantom object.
                        continue
                    if ns is not None and obj.metadata.namespace != ns:
                        continue
                    etype = ev.type
                    if sel or exists:
                        # k8s selector-scoped watch semantics: events are
                        # rewritten by the (old-matched, new-matched)
                        # transition so watchers only ever see objects in
                        # their scope — entering scope is ADDED, leaving
                        # is DELETED, never-in-scope is invisible.
                        # Existence-only terms scope the watch exactly as
                        # they scope the list — list+watch must agree or
                        # informer caches hold objects their own relist
                        # would tombstone.
                        def _m(o):
                            return o is not None and all(
                                o.metadata.labels.get(k) == v
                                for k, v in (sel or {}).items()
                            ) and all(
                                k in o.metadata.labels for k in exists
                            )

                        now_in = _m(obj) and etype != EventType.DELETED
                        was_in = (
                            _m(ev.old_obj)
                            if etype == EventType.MODIFIED
                            else (_m(obj) if etype == EventType.DELETED
                                  else False)
                        )
                        if now_in and was_in:
                            etype = EventType.MODIFIED
                        elif now_in:
                            etype = EventType.ADDED
                        elif was_in:
                            etype = EventType.DELETED
                        else:
                            continue
                    self._stream_line({
                        "type": etype.value, "object": to_dict(obj),
                    })
            except (BrokenPipeError, ConnectionResetError):
                pass  # client went away
            finally:
                store.unsubscribe(events.put)
                watches.deregister(events)

        def _stream_line(self, payload: Dict) -> None:
            self.wfile.write((json.dumps(payload) + "\n").encode())
            self.wfile.flush()

        def do_GET(self):
            self._handle("GET")

        def do_POST(self):
            self._handle("POST")

        def do_PUT(self):
            self._handle("PUT")

        def do_DELETE(self):
            self._handle("DELETE")

        def do_PATCH(self):
            self._handle("PATCH")

    return Handler


class RestServer:
    """In-process apiserver facade; bind port 0 for an ephemeral port.

    ``k8s_mode=True`` serves strict Kubernetes wire JSON + protocol (see
    ``make_rest_handler``) for driving ``kube_client.KubeClusterClient``
    hermetically."""

    def __init__(
        self, cluster: FakeCluster, port: int = 0, k8s_mode: bool = False,
    ):
        self._watches = _WatchRegistry()
        self._httpd = ThreadingHTTPServer(
            ("127.0.0.1", port),
            make_rest_handler(cluster, self._watches, k8s_mode=k8s_mode),
        )
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address
        return f"http://{host}:{port}"

    def start(self) -> "RestServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._watches.close_all()   # wake + drop open watch streams
        self._httpd.shutdown()
        self._httpd.server_close()  # release the port for rebinds
