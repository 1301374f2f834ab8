"""LocalRuntime: one-call wiring of fake cluster + informers + controller.

The in-process equivalent of the reference's process entry ``run()``
(``cmd/controller/main.go:27-57``): build clients, informers, controller, and
start everything. Two drive modes:

- deterministic (tests): ``step()`` advances sim time then drains the queue;
- threaded (CLI demo): ``start_threads()`` runs informer resync + N workers +
  a wall-clock ticker, the reference's goroutine topology.

Counterpart of ``kubeflow_controller_tpu/runtime.py`` (``RemoteRuntime`` and
``LocalRuntime``); the port keeps its own copy (it imports nothing of the
JAX package).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Union

from kubeflow_controller_tpu_torch.api.core import thaw
from kubeflow_controller_tpu_torch.api.serialization import load_job_yaml
from kubeflow_controller_tpu_torch.api.types import JobPhase, LMService, TPUJob
from kubeflow_controller_tpu_torch.api.validation import validate_job, validate_lmservice
from kubeflow_controller_tpu_torch.cluster.client import FakeClusterClient
from kubeflow_controller_tpu_torch.cluster.cluster import FakeCluster, PodRunPolicy
from kubeflow_controller_tpu_torch.controller.controller import Controller, ControllerOptions
from kubeflow_controller_tpu_torch.controller.informer import Informer


class RemoteRuntime:
    """Controller wired to a cluster ONLY over the REST seam.

    The operator topology of the reference's ``main()``
    (``cmd/controller/main.go:31-52``): a controller process that talks to
    an apiserver URL — clients built from a server address, watch-driven
    informers, effects via HTTP. ``cluster_url`` is the ``-master``/
    ``-kubeconfig`` analog. Namespace-scoped (one controller per
    namespace), matching how the kubeflow operators are usually deployed.
    """

    def __init__(
        self,
        cluster_url: str = "",
        namespace: str = "default",
        token: str = "",
        resync_period: float = 30.0,
        watch_timeout_seconds: float = 0,
        k8s: bool = False,
        kube_context=None,
    ):
        self.namespace = namespace
        if k8s or kube_context is not None:
            # Real-Kubernetes wiring (the reference's actual topology:
            # core/v1 + CRD wire JSON, kubeconfig auth, list-then-watch).
            from kubeflow_controller_tpu_torch.cluster.kube_client import (
                KubeClusterClient, KubeWatchSource,
            )

            self.client = KubeClusterClient(
                cluster_url or None, token=token, namespace=namespace,
                kube_context=kube_context,
            )
            self.namespace = namespace = self.client.namespace
            self._sources = [
                KubeWatchSource(self.client, kind, namespace,
                                timeout_seconds=watch_timeout_seconds)
                for kind in ("TPUJob", "Pod", "Service")
            ]
        else:
            from kubeflow_controller_tpu_torch.cluster.rest_client import (
                RestClusterClient, RestWatchSource,
            )

            self.client = RestClusterClient(cluster_url, token=token)
            self._sources = [
                RestWatchSource(self.client, kind, namespace,
                                timeout_seconds=watch_timeout_seconds)
                for kind in ("TPUJob", "Pod", "Service")
            ]
        job_src, pod_src, svc_src = self._sources
        self.job_informer = Informer(job_src, resync_period)
        self.pod_informer = Informer(pod_src, resync_period)
        self.service_informer = Informer(svc_src, resync_period)
        self.controller = Controller(
            self.client,
            self.job_informer,
            self.pod_informer,
            self.service_informer,
            ControllerOptions(resync_period=resync_period),
        )

    def start(self, workers: int = 2) -> None:
        """Sync informers over the wire, then run reconcile workers."""
        self.controller.start()
        self.controller.run(workers)

    def drain(self) -> int:
        """Deterministic drive (tests): controller.start() first."""
        return self.controller.drain()

    def stop(self) -> None:
        self.controller.stop()
        for src in self._sources:
            src.stop()


class LocalRuntime:
    def __init__(
        self,
        default_policy: Optional[PodRunPolicy] = None,
        resync_period: float = 0.0,
        tracer=None,
        workers: Optional[int] = None,
        queue_shards: int = 1,
        use_native_index: Optional[bool] = None,
        watch_shards: int = 8,
        injector=None,
    ):
        # ``use_native_index``: None = auto (C++ object index when the lib
        # loads), False = force the pure-Python fingerprint/label paths,
        # True = require the lib. ``queue_shards``/``watch_shards`` size
        # the key-range sharding of the workqueue and the per-subscriber
        # watch delta queues.
        self.cluster = FakeCluster(
            default_policy=default_policy,
            use_native_index=use_native_index,
            watch_shards=watch_shards,
        )
        self.client = FakeClusterClient(self.cluster)
        # Everything (stores, controller, scheduler) runs on the cluster's
        # simulated clock; threaded mode advances it from a wall-clock ticker.
        # ``tracer`` (obs.Tracer) records control-plane spans — queue
        # wait, per-key sync, requeue events; None = no overhead.
        self._opts = ControllerOptions(
            now_fn=lambda: self.cluster.now, resync_period=resync_period,
            tracer=tracer, queue_shards=queue_shards,
            # Optional dataplane.faults.FaultInjector, threaded onto the
            # informers by the controller (docs/chaos.md).
            injector=injector,
        )
        if workers is not None:
            self._opts.workers = workers
        self._wire()
        self._ticker: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _wire(self) -> None:
        """Build informers + controller over the cluster stores and start
        them (shared by __init__ and restart_controller)."""
        self.job_informer = Informer(self.cluster.jobs, self._opts.resync_period)
        self.pod_informer = Informer(self.cluster.pods, self._opts.resync_period)
        self.service_informer = Informer(self.cluster.services, self._opts.resync_period)
        self.lmservice_informer = Informer(
            self.cluster.lmservices, self._opts.resync_period)
        self.controller = Controller(
            self.client,
            self.job_informer,
            self.pod_informer,
            self.service_informer,
            self._opts,
            lmservice_informer=self.lmservice_informer,
        )
        self.controller.start()

    # -- job API -------------------------------------------------------------

    def submit(self, job_or_yaml: Union[TPUJob, str]) -> TPUJob:
        job = (
            job_or_yaml if isinstance(job_or_yaml, TPUJob)
            else load_job_yaml(job_or_yaml)
        )
        validate_job(job)
        return self.cluster.jobs.create(job)

    def get_job(self, namespace: str, name: str) -> Optional[TPUJob]:
        # Owned mutable copy (the store's snapshot is frozen): callers
        # routinely get-modify-update, matching the wire-client contract.
        return thaw(self.cluster.jobs.try_get(namespace, name))

    def delete_job(self, namespace: str, name: str) -> None:
        self.cluster.jobs.delete(namespace, name)

    # -- lmservice API -------------------------------------------------------

    def submit_lmservice(self, svc: LMService) -> LMService:
        validate_lmservice(svc)
        return self.cluster.lmservices.create(svc)

    def get_lmservice(self, namespace: str, name: str) -> Optional[LMService]:
        return thaw(self.cluster.lmservices.try_get(namespace, name))

    def delete_lmservice(self, namespace: str, name: str) -> None:
        self.cluster.lmservices.delete(namespace, name)

    # -- deterministic drive -------------------------------------------------

    def step(self, dt: float = 1.0, steps: int = 1) -> None:
        """One simulation step: controller reacts, cluster advances, controller
        reacts again. Order matters: reconcile-before-tick lets a fresh job's
        pods exist before the scheduler looks."""
        for _ in range(steps):
            self.controller.drain()
            self.cluster.tick(dt)
            self.controller.drain()

    def run_until(
        self,
        predicate: Callable[[], bool],
        dt: float = 1.0,
        max_steps: int = 500,
    ) -> bool:
        for _ in range(max_steps):
            if predicate():
                return True
            self.step(dt)
        return predicate()

    def wait_for_phase(
        self, namespace: str, name: str, phase: JobPhase,
        dt: float = 1.0, max_steps: int = 500,
    ) -> bool:
        return self.run_until(
            lambda: (
                (j := self.get_job(namespace, name)) is not None
                and j.status.phase == phase
            ),
            dt=dt, max_steps=max_steps,
        )

    def restart_controller(self) -> None:
        """Simulate a controller-process crash + restart: the new controller
        has total amnesia (fresh informers, fresh expectations, fresh queue)
        and must rebuild its world from the store — the level-trigger promise
        the reference's expectations race comment describes
        (``pkg/controller/controller.go:259-262``)."""
        was_threaded = len(self.controller._threads)
        for inf in (self.job_informer, self.pod_informer,
                    self.service_informer, self.lmservice_informer):
            inf.stop()
        self.controller.queue.shutdown()
        self._wire()
        if was_threaded:  # threaded mode: the successor needs workers too
            self.controller.run(was_threaded)

    # -- threaded drive ------------------------------------------------------

    def start_threads(
        self, workers: Optional[int] = None, tick_interval: float = 0.05
    ) -> None:
        self.controller.run(workers if workers is not None
                            else self._opts.workers)
        def ticker() -> None:
            while not self._stop.wait(tick_interval):
                self.cluster.tick(tick_interval)
        self._ticker = threading.Thread(target=ticker, daemon=True, name="cluster-ticker")
        self._ticker.start()

    def stop(self) -> None:
        self._stop.set()
        self.controller.stop()
