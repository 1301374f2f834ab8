"""tpujobctl — the operational CLI.

The reference's operator flow is kubectl against an apiserver plus a
controller process (``docs/get_started.md:10-63``); here the same split is
one daemon (``tpujobctl serve`` = controller + in-process cluster + HTTP API)
and thin client commands that speak JSON to it. A one-shot ``run`` mode
drives a job to completion in-process for demos/CI with no daemon.

Commands:
    serve               run controller + fake cluster + HTTP API
    serve --cluster-url reconcile a remote apiserver (the -master analog)
    apiserver           run the REST apiserver facade (pairs with the above)
    submit -f job.yml   create a TPUJob
    list / get / describe / delete / logs
    events              cluster events (k8s Events analog)
    traces              per-sync reconcile traces (latency observability)
    pools               TPU slice pool inventory
    add-pool            register slice capacity (e.g. v5e-16 x2)
    validate -f         schema/semantic validation only
    run -f job.yml      one-shot: submit + reconcile to completion in-process
    version

Counterpart of ``kubeflow_controller_tpu/cli.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import kubeflow_controller_tpu_torch as pkg
from kubeflow_controller_tpu_torch.api.serialization import (
    job_from_dict, job_to_dict, load_job_yaml,
)
from kubeflow_controller_tpu_torch.api.types import JobPhase
from kubeflow_controller_tpu_torch.api.validation import ValidationError, validate_job
from kubeflow_controller_tpu_torch.cluster.cluster import PodRunPolicy
from kubeflow_controller_tpu_torch.runtime import LocalRuntime

DEFAULT_PORT = 8377


# -- server ------------------------------------------------------------------

def _make_handler(rt: LocalRuntime):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, payload: Any) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _route(self, method: str) -> None:
            try:
                parts = [p for p in self.path.split("/") if p]
                body = {}
                if method in ("POST", "PUT", "DELETE"):
                    n = int(self.headers.get("Content-Length") or 0)
                    if n:
                        body = json.loads(self.rfile.read(n))
                self._send(200, self._dispatch(method, parts, body))
            except ValidationError as e:
                self._send(400, {"error": "validation", "problems": e.errors})
            except KeyError as e:
                self._send(404, {"error": f"not found: {e}"})
            except Exception as e:  # surface, don't crash the daemon
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def _dispatch(self, method: str, parts, body) -> Any:
            cluster = rt.cluster
            if parts == ["healthz"]:
                return {"ok": True, "now": cluster.now}
            if parts == ["version"]:
                return {"version": pkg.build_version()}
            if parts == ["jobs"] and method == "POST":
                job = job_from_dict(body)
                validate_job(job)
                return job_to_dict(rt.submit(job))
            if parts[:1] == ["jobs"] and method == "GET" and len(parts) == 1:
                ns = self.headers.get("X-Namespace", "")
                jobs = cluster.jobs.list(ns or None)
                return {"items": [job_to_dict(j) for j in jobs]}
            if parts[:1] == ["jobs"] and len(parts) == 3:
                ns, name = parts[1], parts[2]
                if method == "GET":
                    return job_to_dict(cluster.jobs.get(ns, name))
                if method == "PUT":
                    from kubeflow_controller_tpu_torch.api.apply import (
                        apply_job_spec,
                    )

                    new = job_from_dict(body)
                    validate_job(new)
                    return job_to_dict(apply_job_spec(
                        get=lambda: cluster.jobs.try_get(ns, name),
                        create=rt.submit,
                        update=cluster.jobs.update,
                        new=new,
                    ))
                if method == "DELETE":
                    rt.delete_job(ns, name)
                    return {"deleted": f"{ns}/{name}"}
            if (
                parts[:1] == ["jobs"] and len(parts) == 4
                and method == "POST" and parts[3] in ("suspend", "resume")
            ):
                ns, name, verb = parts[1], parts[2], parts[3]

                def set_suspend(j, want=(verb == "suspend")):
                    j.spec.suspend = want
                return job_to_dict(
                    cluster.jobs.mutate(ns, name, set_suspend)
                )
            if parts[:1] == ["pods"] and method == "GET":
                ns = parts[1] if len(parts) > 1 else None
                return {"items": [
                    {
                        "name": p.metadata.name,
                        "namespace": p.metadata.namespace,
                        "phase": p.status.phase.value,
                        "slice": p.spec.assigned_slice,
                        "labels": dict(p.metadata.labels),
                    }
                    for p in cluster.pods.list(ns)
                ]}
            if parts[:1] == ["logs"] and method == "GET" and len(parts) == 3:
                ns, name = parts[1], parts[2]
                lines = cluster.get_pod_logs(name)
                if not lines:  # maybe a job name: aggregate its pods' logs
                    pods = [
                        pp for pp in cluster.pods.list(ns)
                        if pp.metadata.labels.get("tpu.kubeflow.dev/job") == name
                    ]
                    lines = [
                        (t, f"[{pp.metadata.name}] {line}")
                        for pp in pods
                        for (t, line) in cluster.get_pod_logs(pp.metadata.name)
                    ]
                    lines.sort(key=lambda x: x[0])
                return {"items": [
                    {"time": t, "line": line} for (t, line) in lines
                ]}
            if parts == ["events"] and method == "GET":
                return {"items": [
                    {"time": t, "kind": k, "name": n, "reason": r, "message": m}
                    for (t, k, n, r, m) in cluster.cluster_events[-200:]
                ]}
            if parts == ["traces"] and method == "GET":
                return {"items": [
                    {
                        "key": tr.key, "outcome": tr.outcome,
                        "duration_ms": round(tr.duration * 1000, 3),
                        "error": tr.error, "note": tr.note,
                    }
                    # traces is a bounded deque: copy before slicing
                    for tr in list(rt.controller.traces)[-200:]
                ]}
            if parts[:1] == ["slices"] and method == "GET" and len(parts) == 2:
                from kubeflow_controller_tpu_torch.cluster.slices import (
                    slice_to_dict,
                )

                return {"items": [
                    slice_to_dict(s)
                    for s in cluster.slice_pool.holdings(parts[1])
                ]}
            if parts == ["pools"] and method == "GET":
                return {"items": [
                    {
                        "name": s.name,
                        "accelerator": s.shape.accelerator_type,
                        "healthy": s.healthy, "holder": s.holder,
                    }
                    for s in cluster.slice_pool.list()
                ]}
            if parts == ["pools"] and method == "POST":
                names = cluster.slice_pool.add_pool(
                    body["acceleratorType"], int(body.get("count", 1))
                )
                return {"added": names}
            raise KeyError(self.path)

        def do_GET(self):
            self._route("GET")

        def do_POST(self):
            self._route("POST")

        def do_DELETE(self):
            self._route("DELETE")

        def do_PUT(self):
            self._route("PUT")

    return Handler


def _add_pools(slice_pool, pools) -> None:
    """Register slice capacity from repeated --pool specs like "v5e-16x2"
    (accelerator type, optional xCOUNT suffix)."""
    for pool in pools or []:
        accel, _, count = pool.rpartition("x")
        if not accel or not count.isdigit():
            accel, count = pool, "1"
        slice_pool.add_pool(accel, int(count))


def setup_logging(args) -> int:
    """Configure daemon logging from ``-v``/``--log-level``. The reference's controller runs with graded glog
    verbosity, ``-logtostderr -v 4`` (docs/development.md:57); the glog
    ``-v`` scale maps 0 -> WARNING, 1..3 -> INFO, >= 4 -> DEBUG, and
    ``--log-level`` names a Python level directly (it wins when both are
    given). Returns the effective level; logs go to stderr like glog's
    ``-logtostderr``."""
    import logging

    if getattr(args, "log_level", ""):
        level = getattr(logging, args.log_level.upper())
    elif getattr(args, "v", None) is not None:
        level = (
            logging.DEBUG if args.v >= 4
            else logging.INFO if args.v >= 1
            else logging.WARNING
        )
    else:
        level = logging.INFO
    logging.basicConfig(
        level=level, stream=sys.stderr, force=True,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s",
    )
    return level


def cmd_serve(args) -> int:
    if args.cluster_url or args.kubeconfig or args.in_cluster:
        return _serve_remote(args)
    if getattr(args, "k8s_wire", False):
        # --k8s-wire selects the wire dialect for a REMOTE target; with no
        # target it would be silently ignored — refuse instead.
        print(
            "error: --k8s-wire requires a remote cluster target "
            "(--cluster-url, --kubeconfig, or --in-cluster)",
            file=sys.stderr,
        )
        return 2
    rt = LocalRuntime(
        default_policy=PodRunPolicy(
            start_delay=args.pod_start_delay, run_duration=args.pod_run_duration
        ),
        resync_period=30.0,
    )
    _add_pools(rt.cluster.slice_pool, args.pool)
    rt.start_threads(workers=args.workers)
    # After informers primed: exempt the boot heap from GC scans and make
    # collections rare (measured 421 -> 310 us/sync at 5000 jobs).
    from kubeflow_controller_tpu_torch.util.gc_tuning import tune_for_control_plane

    tune_for_control_plane()
    server = ThreadingHTTPServer(("127.0.0.1", args.port), _make_handler(rt))
    # First SIGINT/SIGTERM drains gracefully; second hard-exits
    # (util/signals.py, parity with reference pkg/util/signals). Installed
    # before announcing readiness so a signal right after the banner is safe.
    from kubeflow_controller_tpu_torch.util.signals import setup_signal_handler

    stop = setup_signal_handler()
    threading.Thread(
        target=lambda: (stop.wait(), server.shutdown()), daemon=True
    ).start()
    print(f"tpujobctl serve: listening on http://127.0.0.1:{args.port} "
          f"({args.workers} reconcile workers)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        rt.stop()
    print("tpujobctl serve: stopped")
    return 0


def _serve_remote(args) -> int:
    """Controller-only mode against an apiserver — the reference's
    ``-master``/``-kubeconfig`` topology (``cmd/controller/main.go:31-52``):
    no in-process cluster, no submit API; jobs are created against the
    apiserver. Three dial modes:

    - ``--cluster-url URL``              framework wire JSON (tpujobctl
                                         apiserver);
    - ``--cluster-url URL --k8s-wire``   strict Kubernetes wire JSON
                                         (a real apiserver by URL+token, or
                                         ``apiserver --k8s-wire``);
    - ``--kubeconfig PATH`` /            a real cluster via kubeconfig
      ``--in-cluster``                   (auth + TLS + namespace resolved
                                         the way client-go's clientcmd
                                         does, main.go:31-43).
    """
    from kubeflow_controller_tpu_torch.runtime import RemoteRuntime
    from kubeflow_controller_tpu_torch.util.signals import setup_signal_handler

    kube_context = None
    if args.kubeconfig or args.in_cluster:
        from kubeflow_controller_tpu_torch.cluster.kubeconfig import (
            in_cluster_context, load_kubeconfig,
        )

        if args.in_cluster:
            kube_context = in_cluster_context()
            if kube_context is None:
                print("tpujobctl serve: --in-cluster but no service-account "
                      "token mounted", flush=True)
                return 1
        else:
            from kubeflow_controller_tpu_torch.cluster.kubeconfig import (
                KubeconfigError,
            )

            try:
                kube_context = load_kubeconfig(args.kubeconfig, args.context)
            except KubeconfigError as e:
                print(f"tpujobctl serve: {e}", flush=True)
                return 1
    rt = RemoteRuntime(
        args.cluster_url or "",
        namespace=args.namespace,
        token=args.token or "",
        k8s=bool(args.k8s_wire or kube_context is not None),
        kube_context=kube_context,
    )
    target = args.cluster_url or rt.client.base_url
    stop = setup_signal_handler()
    rt.start(workers=args.workers)
    from kubeflow_controller_tpu_torch.util.gc_tuning import tune_for_control_plane

    tune_for_control_plane()
    print(f"tpujobctl serve: reconciling {rt.namespace!r} via "
          f"{target} ({args.workers} workers)", flush=True)
    stop.wait()
    rt.stop()
    print("tpujobctl serve: stopped")
    return 0


def cmd_apiserver(args) -> int:
    """Run the apiserver facade over a FakeCluster (with a wall-clock
    ticker driving pod lifecycle) — the process a remote `serve
    --cluster-url` controller reconciles against."""
    from kubeflow_controller_tpu_torch.cluster.cluster import FakeCluster
    from kubeflow_controller_tpu_torch.cluster.rest_server import RestServer
    from kubeflow_controller_tpu_torch.util.signals import setup_signal_handler

    cluster = FakeCluster(default_policy=PodRunPolicy(
        start_delay=args.pod_start_delay, run_duration=args.pod_run_duration
    ))
    _add_pools(cluster.slice_pool, args.pool)
    server = RestServer(
        cluster, port=args.listen, k8s_mode=bool(args.k8s_wire)
    ).start()
    stop = setup_signal_handler()

    def ticker() -> None:
        while not stop.wait(0.05):
            cluster.tick(0.05)

    threading.Thread(target=ticker, daemon=True, name="ticker").start()
    print(f"tpujobctl apiserver: listening on {server.url}", flush=True)
    stop.wait()
    server.stop()
    print("tpujobctl apiserver: stopped")
    return 0


# -- client helpers ----------------------------------------------------------

def _req(args, method: str, path: str, payload: Optional[Dict] = None) -> Dict:
    url = f"http://127.0.0.1:{args.port}{path}"
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        body = json.loads(e.read() or b"{}")
        raise SystemExit(f"error: {body.get('error')}"
                         + ("".join("\n  - " + p for p in body.get("problems", []))))
    except urllib.error.URLError as e:
        raise SystemExit(
            f"error: cannot reach daemon at {url} ({e.reason}); "
            f"start one with `tpujobctl serve`"
        )


def _load_manifest(path: str):
    src = sys.stdin.read() if path == "-" else open(path).read()
    return load_job_yaml(src)


def cmd_submit(args) -> int:
    job = _load_manifest(args.filename)
    out = _req(args, "POST", "/jobs", job_to_dict(job))
    print(f"tpujob {out['metadata']['namespace']}/{out['metadata']['name']} created")
    return 0


def cmd_apply(args) -> int:
    """Create-or-update from a manifest (kubectl-apply analog). A spec
    change on a live job triggers a voluntary gang restart (resize)."""
    job = _load_manifest(args.filename)
    ns = job.metadata.namespace or "default"
    out = _req(args, "PUT", f"/jobs/{ns}/{job.metadata.name}",
               job_to_dict(job))
    print(f"tpujob {out['metadata']['namespace']}/{out['metadata']['name']} applied")
    return 0


def cmd_list(args) -> int:
    items = _req(args, "GET", "/jobs")["items"]
    rows = [("NAMESPACE", "NAME", "PHASE", "RESTARTS", "PRIO", "AGE")]
    now = _req(args, "GET", "/healthz")["now"]
    for j in items:
        st = j.get("status", {})
        restarts = st.get("restarts", 0)
        resizes = st.get("resizes", 0)
        rows.append((
            j["metadata"].get("namespace", ""),
            j["metadata"].get("name", ""),
            st.get("phase", ""),
            (f"{restarts - resizes}"
             + (f"+{resizes}rs" if resizes else "")),
            str(j.get("spec", {}).get("priority", 0)),
            f"{now - j['metadata'].get('creationTimestamp', now):.0f}s",
        ))
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    for r in rows:
        print("  ".join(c.ljust(w) for c, w in zip(r, widths)))
    return 0


def cmd_get(args) -> int:
    out = _req(args, "GET", f"/jobs/{args.namespace}/{args.name}")
    print(json.dumps(out, indent=2, default=str))
    return 0


def cmd_describe(args) -> int:
    j = _req(args, "GET", f"/jobs/{args.namespace}/{args.name}")
    st = j.get("status", {})
    meta = j["metadata"]
    print(f"Name:       {meta['name']}\nNamespace:  {meta.get('namespace')}")
    print(f"Phase:      {st.get('phase')}    Reason: {st.get('reason', '')}")
    print(f"RuntimeID:  {j['spec'].get('runtimeId', '')}")
    restarts = st.get("restarts", 0)
    resizes = st.get("resizes", 0)
    if restarts or resizes:
        print(f"Restarts:   {restarts} total "
              f"({resizes} voluntary resizes, "
              f"{restarts - resizes} failure recoveries)")
    sub, run = st.get("submitTime"), st.get("allRunningTime")
    if sub and run:
        print(f"Submit -> all-running: {run - sub:.2f}s"
              "   (north-star latency metric)")
    for rs in st.get("replicaStatuses", []):
        print(f"Replicas[{rs.get('type')}]: {rs.get('states')}")
    for c in st.get("conditions", []) or []:
        print(f"Condition: {c.get('type')}={c.get('status')}"
              f" ({c.get('reason', '')})")
    pods = _req(args, "GET", f"/pods/{args.namespace}")["items"]
    mine = [p for p in pods if p["labels"].get("tpu.kubeflow.dev/job") == meta["name"]]
    if mine:
        print("Pods:")
        for p in mine:
            print(f"  {p['name']}  {p['phase']}  slice={p['slice'] or '-'}")
    held = _req(args, "GET", f"/slices/{meta.get('uid', '')}")["items"]
    if held:
        print("Slices:")
        for s in held:
            health = "healthy" if s["healthy"] else "UNHEALTHY"
            print(f"  {s['name']}  {s['accelerator']}  {health}"
                  f"  hosts={len(s['hosts'])}")
    evs = _req(args, "GET", "/events")["items"]
    mine_ev = [e for e in evs if meta["name"] in e["name"]][-10:]
    if mine_ev:
        print("Events:")
        for e in mine_ev:
            print(f"  t={e['time']:.1f} {e['reason']}: {e['message']}")
    return 0


def cmd_delete(args) -> int:
    _req(args, "DELETE", f"/jobs/{args.namespace}/{args.name}")
    print(f"tpujob {args.namespace}/{args.name} deleted")
    return 0


def _follow(fetch, key, show, poll_interval, initial, on_idle=None) -> int:
    """Shared poll-follow loop for logs/events -f.

    The server re-sorts aggregated streams each fetch and returns a
    bounded tail, so index-tracking would drop or repeat entries; track
    per-key COUNTS so a legitimately repeated identical entry still prints
    once per occurrence. ``on_idle`` (if given) is called after 10 quiet
    polls and may return an exit code to stop."""
    from collections import Counter

    emitted = Counter(key(e) for e in initial)
    idle = 0
    try:
        while True:
            time.sleep(poll_interval)
            new = 0
            running = Counter()
            for e in fetch():
                running[key(e)] += 1
                if running[key(e)] > emitted[key(e)]:
                    new += 1
                    show(e)
            emitted = running
            idle = 0 if new else idle + 1
            if idle >= 10 and on_idle is not None:
                rc = on_idle()
                if rc is not None:
                    return rc
    except KeyboardInterrupt:
        return 0


def cmd_logs(args) -> int:
    def fetch():
        return _req(
            args, "GET", f"/logs/{args.namespace}/{args.name}"
        )["items"]

    def show(e):
        print(f"t={e['time']:.1f} {e['line']}", flush=True)

    items = fetch()
    if not items and not args.follow:
        print(f"no logs for {args.namespace}/{args.name}")
        return 1
    for e in items:
        show(e)
    if not args.follow:
        return 0

    def on_idle():
        try:
            _req(args, "GET", f"/jobs/{args.namespace}/{args.name}")
            return None
        except SystemExit:
            return 0   # job deleted and log stream drained

    return _follow(
        fetch, lambda e: (e["time"], e["line"]), show,
        args.poll_interval, items, on_idle,
    )


def cmd_suspend(args) -> int:
    out = _req(args, "POST",
               f"/jobs/{args.namespace}/{args.name}/suspend")
    print(f"tpujob {args.namespace}/{args.name} suspended "
          f"(runtimeId {out['spec'].get('runtimeId', '')})")
    return 0


def cmd_resume(args) -> int:
    _req(args, "POST", f"/jobs/{args.namespace}/{args.name}/resume")
    print(f"tpujob {args.namespace}/{args.name} resumed")
    return 0


def cmd_events(args) -> int:
    def fetch():
        items = _req(args, "GET", "/events")["items"]
        if args.name:
            items = [e for e in items if args.name in e["name"]]
        return items

    def show(e):
        print(f"t={e['time']:.1f} [{e['kind']}/{e['name']}] "
              f"{e['reason']}: {e['message']}", flush=True)

    items = fetch()
    for e in items:
        show(e)
    if not args.follow:
        return 0
    # -f: the kubectl get events --watch analog. The key includes the
    # message (like logs -f includes the line) so distinct events sharing a
    # timestamp/kind/name/reason still count separately.
    return _follow(
        fetch,
        lambda e: (e["time"], e["kind"], e["name"], e["reason"],
                   e["message"]),
        show, args.poll_interval, items,
    )


def cmd_traces(args) -> int:
    for t in _req(args, "GET", "/traces")["items"]:
        err = f" error={t['error']}" if t["error"] else ""
        note = f" note={t['note']}" if t.get("note") else ""
        print(f"{t['key']}  {t['outcome']}  {t['duration_ms']}ms{note}{err}")
    return 0


def cmd_pools(args) -> int:
    for p in _req(args, "GET", "/pools")["items"]:
        health = "healthy" if p["healthy"] else "unhealthy"
        print(f"{p['name']}  {p['accelerator']}  {health}"
              f"  holder={p['holder'] or '-'}")
    return 0


def cmd_add_pool(args) -> int:
    out = _req(args, "POST", "/pools",
               {"acceleratorType": args.accelerator, "count": args.count})
    print(f"added slices: {', '.join(out['added'])}")
    return 0


def cmd_validate(args) -> int:
    try:
        job = _load_manifest(args.filename)
        validate_job(job)
    except ValidationError as e:
        print("invalid:")
        for p in e.errors:
            print(f"  - {p}")
        return 1
    print(f"{job.metadata.namespace}/{job.metadata.name}: valid")
    return 0


def cmd_run(args) -> int:
    """One-shot in-process run: the reference's get-started flow
    (submit, watch phases, exit by terminal phase) without a cluster."""
    job = _load_manifest(args.filename)
    rt = LocalRuntime(
        default_policy=PodRunPolicy(
            start_delay=args.pod_start_delay, run_duration=args.pod_run_duration
        )
    )
    _add_pools(rt.cluster.slice_pool, args.pool)
    rt.submit(job)
    ns, name = job.metadata.namespace, job.metadata.name
    last_phase = None
    deadline = time.time() + args.timeout
    while time.time() < deadline:
        rt.step(dt=0.5)
        j = rt.get_job(ns, name)
        if j and j.status.phase != last_phase:
            last_phase = j.status.phase
            print(f"phase: {last_phase.value}")
        if last_phase in (JobPhase.SUCCEEDED, JobPhase.FAILED):
            break
    j = rt.get_job(ns, name)
    if j is None:
        print(
            f"error: job {ns}/{name} not found (deleted or never reached a "
            f"terminal phase within {args.timeout}s)", file=sys.stderr,
        )
        return 1
    if j.status.submit_time and j.status.all_running_time:
        print(f"submit -> all-running: "
              f"{j.status.all_running_time - j.status.submit_time:.2f}s (sim)")
    print(f"final: {j.status.phase.value} {j.status.reason or ''}".rstrip())
    return 0 if j.status.phase == JobPhase.SUCCEEDED else 1


def cmd_version(args) -> int:
    print(pkg.build_version())
    return 0


# -- argparse wiring ---------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpujobctl", description="TPUJob operations CLI"
    )
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--port", type=int, default=DEFAULT_PORT,
                        help="daemon port (default %(default)s)")
    common.add_argument("-v", type=int, default=None, metavar="N",
                        help="glog-style verbosity (0 warning, 1-3 info, "
                             ">=4 debug) — the reference runs -v 4")
    common.add_argument("--log-level", default="",
                        choices=["", "debug", "info", "warning", "error"],
                        help="explicit log level (overrides -v)")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_parser(name, **kw):
        return sub.add_parser(name, parents=[common], **kw)

    s = add_parser("serve", help="run controller daemon + HTTP API")
    s.add_argument("--workers", type=int, default=2)
    s.add_argument("--pool", action="append",
                   help="slice pool to register, e.g. v5e-16x2 (repeatable)")
    s.add_argument("--pod-start-delay", type=float, default=1.0)
    s.add_argument("--pod-run-duration", type=float, default=10.0)
    s.add_argument("--cluster-url",
                   help="reconcile against this apiserver URL instead of an "
                        "in-process cluster (the -master analog)")
    s.add_argument("--namespace", default="default",
                   help="namespace to reconcile (with --cluster-url)")
    s.add_argument("--token", help="bearer token (with --cluster-url)")
    s.add_argument("--k8s-wire", action="store_true",
                   help="speak strict Kubernetes wire JSON to --cluster-url "
                        "(a real apiserver, or `apiserver --k8s-wire`)")
    s.add_argument("--kubeconfig",
                   help="reconcile a real Kubernetes cluster via this "
                        "kubeconfig (the -kubeconfig analog; implies k8s "
                        "wire)")
    s.add_argument("--context",
                   help="kubeconfig context to use (default: "
                        "current-context)")
    s.add_argument("--in-cluster", action="store_true",
                   help="use the mounted service-account token "
                        "(controller-as-Deployment)")
    s.set_defaults(fn=cmd_serve)

    s = add_parser("apiserver", help="run the REST apiserver facade "
                                     "(pair with serve --cluster-url)")
    s.add_argument("--listen", type=int, default=8378,
                   help="apiserver port (--port is the client-API flag)")
    s.add_argument("--k8s-wire", action="store_true",
                   help="serve strict Kubernetes wire JSON (core/v1 + CRD "
                        "+ status subresource + Nodes)")
    s.add_argument("--pool", action="append",
                   help="slice pool to register, e.g. v5e-16x2 (repeatable)")
    s.add_argument("--pod-start-delay", type=float, default=1.0)
    s.add_argument("--pod-run-duration", type=float, default=10.0)
    s.set_defaults(fn=cmd_apiserver)

    s = add_parser("apply", help="create-or-update a TPUJob from a manifest "
                                 "(spec change on a live job = gang resize)")
    s.add_argument("-f", "--filename", required=True)
    s.set_defaults(fn=cmd_apply)

    s = add_parser("submit", help="submit a TPUJob manifest")
    s.add_argument("-f", "--filename", required=True)
    s.set_defaults(fn=cmd_submit)

    s = add_parser("list", help="list jobs")
    s.set_defaults(fn=cmd_list)

    for nm, fn, hp in (
        ("get", cmd_get, "get a job as JSON"),
        ("describe", cmd_describe, "human-readable job status"),
        ("delete", cmd_delete, "delete a job"),
        ("logs", cmd_logs, "pod (or whole-job) logs"),
        ("suspend", cmd_suspend,
         "pause a job (pods torn down, slices released, checkpoint kept)"),
        ("resume", cmd_resume, "unsuspend: re-gang and resume"),
    ):
        s = add_parser(nm, help=hp)
        s.add_argument("name")
        s.add_argument("-n", "--namespace", default="default")
        if nm == "logs":
            s.add_argument("-f", "--follow", action="store_true",
                           help="stream new lines until Ctrl-C "
                                "(or the job is deleted)")
            s.add_argument("--poll-interval", type=float, default=0.5)
        s.set_defaults(fn=fn)

    s = add_parser("events", help="recent cluster events")
    s.add_argument("name", nargs="?", default="",
                   help="only events whose object name contains this")
    s.add_argument("-f", "--follow", action="store_true")
    s.add_argument("--poll-interval", type=float, default=0.5)
    s.set_defaults(fn=cmd_events)
    add_parser("traces", help="recent reconcile traces").set_defaults(
        fn=cmd_traces)
    add_parser("pools", help="TPU slice inventory").set_defaults(
        fn=cmd_pools)

    s = add_parser("add-pool", help="register TPU slice capacity")
    s.add_argument("accelerator")
    s.add_argument("--count", type=int, default=1)
    s.set_defaults(fn=cmd_add_pool)

    s = add_parser("validate", help="validate a manifest")
    s.add_argument("-f", "--filename", required=True)
    s.set_defaults(fn=cmd_validate)

    s = add_parser("run", help="one-shot in-process job run")
    s.add_argument("-f", "--filename", required=True)
    s.add_argument("--pool", action="append")
    s.add_argument("--timeout", type=float, default=120.0)
    s.add_argument("--pod-start-delay", type=float, default=0.5)
    s.add_argument("--pod-run-duration", type=float, default=3.0)
    s.set_defaults(fn=cmd_run)

    add_parser("version", help="print version").set_defaults(fn=cmd_version)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # -v/--log-level live on the shared parent parser, so configure
    # logging once for EVERY subcommand (not just the daemons — client
    # verbs log kube/debug detail too).
    setup_logging(args)
    try:
        return args.fn(args)
    except BrokenPipeError:
        # `tpujobctl ... | head` closing the pipe is not an error; mimic
        # well-behaved CLIs (suppress the traceback, exit 0).
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
