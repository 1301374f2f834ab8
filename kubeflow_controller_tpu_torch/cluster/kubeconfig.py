"""kubeconfig loading — the reference's client bootstrap, rebuilt.

``cmd/controller/main.go:31-43`` starts from ``clientcmd.BuildConfigFromFlags
(masterURL, kubeconfig)``: resolve a kubeconfig file, pick the current (or
named) context, and produce a rest.Config (server URL + auth + TLS). This
module is that path for the TPU framework: parse the standard kubeconfig YAML
shape (clusters / users / contexts / current-context), resolve one context,
and build the ``ssl.SSLContext`` + headers ``kube_client.KubeClusterClient``
needs.

Supported auth/TLS surface (what GKE and kubeadm configs actually use):

- ``token`` / ``tokenFile`` bearer auth — tokenFile is RE-READ on expiry/
  rejection, because bound service-account tokens rotate (~1h) on real
  clusters and a long-running controller's credentials must follow,
- ``exec`` credential plugins (``users[].user.exec``) — the shape GKE user
  kubeconfigs require since k8s 1.26 (``gke-gcloud-auth-plugin``): spawn
  the plugin, parse the ``ExecCredential`` JSON it prints, cache the token
  until its ``expirationTimestamp``,
- ``client-certificate(-data)`` + ``client-key(-data)`` mTLS,
- ``certificate-authority(-data)`` server verification,
- ``insecure-skip-tls-verify``.

Callers should use ``KubeContext.bearer_token()`` (dynamic) rather than the
static ``token`` field; ``invalidate_token()`` on a 401 forces re-read /
re-exec — ``kube_client.KubeClusterClient`` does both.

Counterpart of ``kubeflow_controller_tpu/cluster/kubeconfig.py``; the port keeps its own
copy (it imports nothing of the JAX package). PyYAML is imported inside
:func:`load_kubeconfig` only: ``in_cluster_context()`` and a context built by
hand need no YAML, so a host without PyYAML still runs the controller
against ``--cluster-url`` or in-cluster.
"""

from __future__ import annotations

import base64
import json
import os
import ssl
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any, Dict, Optional, Tuple


class KubeconfigError(ValueError):
    pass


@dataclass
class KubeContext:
    """One resolved kubeconfig context: everything needed to dial the
    apiserver."""

    server: str
    namespace: str = "default"
    token: str = ""
    ca_data: str = ""            # PEM text
    insecure_skip_tls_verify: bool = False
    client_cert_file: str = ""   # PEM file paths (written if *-data given)
    client_key_file: str = ""
    context_name: str = ""
    # Rotating-credential sources (preferred over the static ``token``
    # snapshot when present):
    token_file: str = ""                      # re-readable bearer token
    exec_config: Optional[Dict[str, Any]] = None  # users[].user.exec verbatim
    # How long a re-read tokenFile is trusted before the next read (bound
    # SA tokens rotate server-side; client-go re-reads on a ~1min cadence).
    token_file_ttl: float = 60.0

    # Key/cert files this loader materialized from *-data fields. They hold
    # private key material: written 0600 (NamedTemporaryFile default) and
    # deleted at process exit via atexit — call cleanup() to remove sooner.
    _temp_files: list = field(default_factory=list)
    _cached_token: str = ""
    _cached_expiry: float = 0.0   # 0 = no expiry; unix seconds otherwise
    # One context is shared by every controller worker thread.
    # ``_token_lock`` guards the cached fields (short critical sections
    # only); ``_refresh_lock`` single-flights the actual credential fetch
    # (exec plugin spawn / tokenFile read) WITHOUT blocking readers:
    # while one thread refreshes, others keep serving the stale cached
    # token instead of queueing behind a 30 s subprocess (a hung
    # plugin would stall every request thread, including watch
    # re-subscriptions).
    _token_lock: Any = field(default_factory=threading.Lock)
    _refresh_lock: Any = field(default_factory=threading.Lock)

    def _fresh_cached(self, now: float) -> str:
        """Cached token iff still valid ('' otherwise); caller holds no
        locks — this takes the cache lock itself."""
        with self._token_lock:
            if self._cached_token and (
                self._cached_expiry == 0 or now < self._cached_expiry
            ):
                return self._cached_token
            return ""

    def bearer_token(self) -> str:
        """The CURRENT bearer token: exec-plugin output cached until its
        expirationTimestamp, a tokenFile re-read on a TTL, or the static
        ``token``. Call ``invalidate_token()`` on a 401 to force refresh.

        Expiry handling is non-blocking for everyone but one refresher:
        the thread that wins ``_refresh_lock`` fetches; concurrent
        callers get the just-expired token immediately (the apiserver
        usually still honours it for a grace window, and a real rejection
        comes back as a 401 -> ``invalidate_token`` -> blocking refresh
        because no stale token remains)."""
        tok = self._fresh_cached(time.time())
        if tok:
            return tok
        if self.exec_config is None and not self.token_file:
            return self.token
        with self._token_lock:
            stale = self._cached_token
        if not self._refresh_lock.acquire(blocking=not stale):
            return stale                 # another thread is refreshing
        try:
            now = time.time()
            tok = self._fresh_cached(now)
            if tok:                      # refreshed while we waited
                return tok
            if self.exec_config is not None:
                tok, expiry = run_exec_plugin(
                    self.exec_config, server=self.server,
                    ca_data=self.ca_data,
                )
            else:
                with open(self.token_file) as f:
                    tok = f.read().strip()
                expiry = now + self.token_file_ttl
            with self._token_lock:
                self._cached_token, self._cached_expiry = tok, expiry
            return tok
        finally:
            self._refresh_lock.release()

    def invalidate_token(self) -> None:
        """Drop cached dynamic credentials (the 401 path: the apiserver
        rejected what we sent, so the rotation beat our cache)."""
        with self._token_lock:
            self._cached_token, self._cached_expiry = "", 0.0

    def cleanup(self) -> None:
        """Remove materialized key/cert temp files."""
        while self._temp_files:
            path = self._temp_files.pop()
            try:
                os.unlink(path)
            except OSError:
                pass

    def ssl_context(self) -> Optional[ssl.SSLContext]:
        """TLS context for https:// servers; None for http:// (dev)."""
        if not self.server.startswith("https"):
            return None
        ctx = ssl.create_default_context()
        if self.insecure_skip_tls_verify:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        elif self.ca_data:
            ctx = ssl.create_default_context(cadata=self.ca_data)
        if self.client_cert_file:
            ctx.load_cert_chain(
                self.client_cert_file, self.client_key_file or None
            )
        return ctx


def _b64_text(data: str) -> str:
    return base64.b64decode(data).decode()


def _parse_rfc3339(ts: str) -> float:
    """RFC3339 timestamp -> unix seconds (0.0 if unparseable — treat as no
    expiry and rely on 401-driven invalidation). Accepts both the 'Z'
    suffix and numeric offsets; a naive timestamp is read as UTC."""
    try:
        dt = datetime.fromisoformat(ts.replace("Z", "+00:00"))
    except ValueError:
        return 0.0
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return dt.timestamp()


def run_exec_plugin(
    cfg: Dict[str, Any], server: str = "", ca_data: str = "",
    timeout: float = 30.0,
) -> Tuple[str, float]:
    """Spawn a ``users[].user.exec`` credential plugin and parse the
    ``ExecCredential`` it prints (client.authentication.k8s.io protocol —
    what client-go's exec provider does for ``gke-gcloud-auth-plugin``).

    Returns (token, expiry_unix_seconds); expiry 0.0 means "no expiry
    stated" (cache until a 401 invalidates). Raises KubeconfigError on a
    non-zero exit, bad JSON, or a credential without a token.
    """
    command = cfg.get("command")
    if not command:
        raise KubeconfigError("kubeconfig: exec entry has no command")
    argv = [command, *(cfg.get("args") or [])]
    env = dict(os.environ)
    for item in cfg.get("env") or []:
        env[str(item.get("name"))] = str(item.get("value", ""))
    api_version = cfg.get(
        "apiVersion", "client.authentication.k8s.io/v1beta1"
    )
    exec_info: Dict[str, Any] = {
        "apiVersion": api_version,
        "kind": "ExecCredential",
        "spec": {"interactive": False},
    }
    if cfg.get("provideClusterInfo") and server:
        cluster: Dict[str, Any] = {"server": server}
        if ca_data:
            cluster["certificate-authority-data"] = base64.b64encode(
                ca_data.encode()
            ).decode()
        exec_info["spec"]["cluster"] = cluster
    env["KUBERNETES_EXEC_INFO"] = json.dumps(exec_info)
    try:
        proc = subprocess.run(
            argv, env=env, capture_output=True, timeout=timeout,
        )
    except FileNotFoundError:
        raise KubeconfigError(
            f"kubeconfig: exec plugin {command!r} not found on PATH"
        ) from None
    except subprocess.TimeoutExpired:
        raise KubeconfigError(
            f"kubeconfig: exec plugin {command!r} timed out after "
            f"{timeout:.0f}s"
        ) from None
    if proc.returncode != 0:
        raise KubeconfigError(
            f"kubeconfig: exec plugin {command!r} failed "
            f"(rc={proc.returncode}): "
            f"{proc.stderr.decode(errors='replace').strip()[:500]}"
        )
    try:
        cred = json.loads(proc.stdout)
    except json.JSONDecodeError:
        raise KubeconfigError(
            f"kubeconfig: exec plugin {command!r} printed invalid JSON"
        ) from None
    status = (cred or {}).get("status") or {}
    token = status.get("token", "")
    if not token:
        raise KubeconfigError(
            f"kubeconfig: exec plugin {command!r} returned no status.token"
        )
    exp = status.get("expirationTimestamp")
    return str(token), _parse_rfc3339(exp) if exp else 0.0


def _materialize(pem_text: str, suffix: str, holder: list) -> str:
    import atexit

    f = tempfile.NamedTemporaryFile(
        "w", suffix=suffix, delete=False, prefix="tpujob-kubeconfig-"
    )
    f.write(pem_text)
    f.close()
    holder.append(f.name)
    atexit.register(lambda path=f.name: _unlink_quiet(path))
    return f.name


def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


def _by_name(seq: Any, name: str, what: str) -> Dict[str, Any]:
    for item in seq or []:
        if item.get("name") == name:
            return item
    raise KubeconfigError(f"kubeconfig: no {what} named {name!r}")


def default_kubeconfig_path() -> str:
    """First effective kubeconfig path (display/back-compat). Loading
    honours the FULL ``$KUBECONFIG`` list — see ``kubeconfig_paths``."""
    return kubeconfig_paths()[0]


def kubeconfig_paths() -> list:
    """``$KUBECONFIG`` as clientcmd reads it: an ``os.pathsep``-separated
    list of files (``:`` on unix), falling back to ``~/.kube/config``.
    Matches the reference's loader
    (``cmd/controller/main.go:31-34`` -> clientcmd's
    ``NewDefaultClientConfigLoadingRules``)."""
    env = os.environ.get("KUBECONFIG", "")
    paths = [p for p in env.split(os.pathsep) if p]
    return paths or [os.path.expanduser("~/.kube/config")]


def merge_kubeconfig_docs(docs: Any) -> Dict[str, Any]:
    """clientcmd merge precedence across multiple kubeconfig files: for
    the named lists (clusters/contexts/users) the FIRST file to define a
    name wins and later files only contribute new names; for scalar
    fields (current-context, preferences) the first non-empty value
    wins. First-wins applies WITHIN one file too: the seen-name set grows
    as entries append, so a duplicate name later in the same document is
    dropped instead of silently shadowing lookups (clientcmd merges maps
    keyed by name, which collapses intra-file dupes the same way)."""
    out: Dict[str, Any] = {}
    for doc in docs:
        for key in ("clusters", "contexts", "users"):
            have = {e.get("name") for e in out.get(key) or []}
            for entry in doc.get(key) or []:
                if entry.get("name") not in have:
                    have.add(entry.get("name"))
                    out.setdefault(key, []).append(entry)
        for k, v in doc.items():
            if k in ("clusters", "contexts", "users"):
                continue
            if not out.get(k):
                out[k] = v
    return out


def load_kubeconfig(
    path: Optional[str] = None, context: Optional[str] = None,
) -> KubeContext:
    """Parse kubeconfig file(s) and resolve one context to a KubeContext.

    ``path`` defaults to the ``$KUBECONFIG`` path LIST (clientcmd
    semantics: multiple files merged, first definition of a name wins)
    then ``~/.kube/config``; an explicit ``path`` may itself be a
    pathsep-separated list. Missing files in a multi-path list are
    skipped (clientcmd does the same); it is an error for ALL of them to
    be missing. ``context`` defaults to the merged ``current-context``.
    """
    import yaml

    if path:
        paths = [p for p in str(path).split(os.pathsep) if p]
    else:
        paths = kubeconfig_paths()
    docs = []
    for p in paths:
        try:
            with open(p) as f:
                doc = yaml.safe_load(f)
        except FileNotFoundError:
            continue
        except yaml.YAMLError as e:
            raise KubeconfigError(
                f"kubeconfig {p}: invalid YAML: {e}"
            ) from None
        if doc is None:
            continue
        if not isinstance(doc, dict):
            raise KubeconfigError(f"kubeconfig {p}: not a mapping")
        docs.append(doc)
    if not docs:
        raise KubeconfigError(
            "kubeconfig not found: " + os.pathsep.join(paths)
        )
    return resolve_context(merge_kubeconfig_docs(docs), context)


def resolve_context(
    doc: Dict[str, Any], context: Optional[str] = None,
) -> KubeContext:
    ctx_name = context or doc.get("current-context")
    if not ctx_name:
        raise KubeconfigError(
            "kubeconfig: no context requested and no current-context set"
        )
    ctx = _by_name(doc.get("contexts"), ctx_name, "context").get("context") or {}
    cluster = _by_name(
        doc.get("clusters"), ctx.get("cluster", ""), "cluster"
    ).get("cluster") or {}
    user: Dict[str, Any] = {}
    if ctx.get("user"):
        user = _by_name(doc.get("users"), ctx["user"], "user").get("user") or {}

    server = cluster.get("server", "")
    if not server:
        raise KubeconfigError(
            f"kubeconfig: cluster for context {ctx_name!r} has no server"
        )

    out = KubeContext(
        server=server.rstrip("/"),
        namespace=ctx.get("namespace", "default"),
        insecure_skip_tls_verify=bool(
            cluster.get("insecure-skip-tls-verify", False)
        ),
        context_name=ctx_name,
    )

    if cluster.get("certificate-authority-data"):
        out.ca_data = _b64_text(cluster["certificate-authority-data"])
    elif cluster.get("certificate-authority"):
        with open(cluster["certificate-authority"]) as f:
            out.ca_data = f.read()

    if user.get("token"):
        out.token = str(user["token"])
    elif user.get("tokenFile"):
        # Snapshot for callers that read .token, but keep the path so
        # bearer_token() follows rotation.
        out.token_file = str(user["tokenFile"])
        with open(out.token_file) as f:
            out.token = f.read().strip()
    if user.get("auth-provider"):
        # Legacy client-go auth-provider stanzas (gcp/azure/oidc) were
        # removed upstream in favour of exec credential plugins; fail
        # with guidance rather than silently serving unauthenticated
        # requests.
        name = (user["auth-provider"] or {}).get("name", "?")
        raise KubeconfigError(
            f"kubeconfig: user for context {ctx_name!r} uses the legacy "
            f"auth-provider {name!r}, which is not supported — migrate "
            "to an exec credential plugin (users[].user.exec), e.g. "
            "gke-gcloud-auth-plugin for GKE"
        )
    if user.get("exec"):
        exec_cfg = user["exec"]
        if not isinstance(exec_cfg, dict):
            raise KubeconfigError(
                f"kubeconfig: user for context {ctx_name!r}: exec entry "
                "must be a mapping"
            )
        out.exec_config = exec_cfg

    if user.get("client-certificate-data"):
        out.client_cert_file = _materialize(
            _b64_text(user["client-certificate-data"]), ".crt",
            out._temp_files,
        )
    elif user.get("client-certificate"):
        out.client_cert_file = user["client-certificate"]
    if user.get("client-key-data"):
        out.client_key_file = _materialize(
            _b64_text(user["client-key-data"]), ".key", out._temp_files,
        )
    elif user.get("client-key"):
        out.client_key_file = user["client-key"]

    return out


def in_cluster_context() -> Optional[KubeContext]:
    """The in-cluster config path (mounted service-account token), the way
    controllers deployed as k8s Deployments authenticate."""
    sa = "/var/run/secrets/kubernetes.io/serviceaccount"
    host = os.environ.get("KUBERNETES_SERVICE_HOST")
    port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
    token_path = os.path.join(sa, "token")
    if not host or not os.path.exists(token_path):
        return None
    with open(token_path) as f:
        token = f.read().strip()
    ca_path = os.path.join(sa, "ca.crt")
    ca_data = ""
    if os.path.exists(ca_path):
        with open(ca_path) as f:
            ca_data = f.read()
    ns_path = os.path.join(sa, "namespace")
    namespace = "default"
    if os.path.exists(ns_path):
        with open(ns_path) as f:
            namespace = f.read().strip() or "default"
    return KubeContext(
        server=f"https://{host}:{port}",
        namespace=namespace,
        token=token,
        # Bound SA tokens rotate (~1h): keep the path so bearer_token()
        # re-reads instead of pinning the boot-time value for the life of
        # the controller.
        token_file=token_path,
        ca_data=ca_data,
    )
