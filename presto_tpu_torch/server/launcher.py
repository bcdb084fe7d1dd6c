"""Config-file bootstrap: ``etc/`` directory -> running node.

Reference parity: ``PrestoServer`` + the three config tiers of
SURVEY.md §5.6 — tier 1 ``etc/config.properties`` +
``etc/node.properties`` (static node config, unknown keys fail fast),
tier 2 ``etc/catalog/*.properties`` (one connector instance per file,
``connector.name=`` selects the factory), tier 3 session properties
(presto_tpu_torch.session, per-query).

The PyTorch counterpart of ``presto_tpu/server/launcher.py``. A node
boots on the CUDA device (``launch(..., device="cpu")`` for tests).
The connectors are the port's, the file connectors (``parquet``,
``orc``, ``hive``) among them; an ``etc/`` that names an unknown one
fails fast with "unknown connector", never skipping the catalog. A
coordinator with
``pool.max-workers`` runs the elastic pool through
:class:`LocalWorkerPoolProvider`: its workers are threads of the
coordinator's process on the coordinator's device.

Usage::

    python -m presto_tpu_torch.server.launcher --etc-dir etc/

with ``etc/config.properties`` like::

    coordinator=true
    http-server.port=8080
    query.max-memory-per-node=4GB

    # workers instead set:
    # coordinator=false
    # discovery.uri=http://coordinator-host:8080

and ``etc/catalog/tpch.properties``::

    connector.name=tpch
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
from typing import Dict, Optional, Tuple

from presto_tpu_torch.connectors import create_connector
from presto_tpu_torch.exec.staging import CatalogManager
from presto_tpu_torch.server.pool import WorkerPoolProvider
from presto_tpu_torch.session import NodeConfig


def parse_properties(path: str) -> Dict[str, str]:
    """java-.properties-style ``key=value`` lines; # comments; blank
    lines ignored (reference: airlift config loading)."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if "=" not in line:
                raise ValueError(
                    f"{path}:{lineno}: expected key=value, got {line!r}"
                )
            k, _, v = line.partition("=")
            out[k.strip()] = v.strip()
    return out


def load_etc(etc_dir: str) -> Tuple[NodeConfig, CatalogManager]:
    """etc/ directory -> (node config, mounted catalogs).

    ``config.properties`` is required; ``node.properties`` merges in
    when present; every ``catalog/*.properties`` mounts one connector
    (the file stem is the catalog name)."""
    cfg_path = os.path.join(etc_dir, "config.properties")
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(f"missing {cfg_path}")
    props = parse_properties(cfg_path)
    node_path = os.path.join(etc_dir, "node.properties")
    if os.path.exists(node_path):
        merged = parse_properties(node_path)
        merged.update(props)  # config.properties wins on conflict
        props = merged
    config = NodeConfig(props)  # unknown keys fail fast here

    catalogs = CatalogManager()
    cat_dir = os.path.join(etc_dir, "catalog")
    if os.path.isdir(cat_dir):
        for fn in sorted(os.listdir(cat_dir)):
            if not fn.endswith(".properties"):
                continue
            cat_props = parse_properties(os.path.join(cat_dir, fn))
            cname = cat_props.pop("connector.name", None)
            if cname is None:
                raise ValueError(
                    f"{fn}: catalog file must set connector.name"
                )
            catalog = fn[: -len(".properties")]
            catalogs.register(catalog, create_connector(cname, **cat_props))
    return config, catalogs


class LocalWorkerPoolProvider(WorkerPoolProvider):
    """In-process pool provider: the zero-dependency shape of the
    elastic-pool SPI (server.pool.WorkerPoolProvider). ``spawn``
    starts a WorkerServer thread in THIS process pointed at the
    coordinator, on ``device`` (None: the CUDA device, as every node);
    ``drain`` routes through the real drain protocol
    (``PUT /v1/state/drain`` semantics via ``WorkerServer.drain`` on a
    background thread), so scale-down is identical to a rolling
    restart. Real deployments implement the same two methods against
    their scheduler (k8s replicas, cloud instance groups) — autoscaled
    capacity defaults to PREEMPTIBLE, which the scheduler treats as
    first-class (spool-backed producers there, gather/merge on stable
    nodes)."""

    def __init__(
        self,
        coordinator_uri: str,
        config=None,
        catalogs=None,
        preemptible: bool = True,
        device=None,
    ):
        self.coordinator_uri = coordinator_uri
        self.config = config
        self.catalogs = catalogs
        self.preemptible = preemptible
        self.device = device
        self.workers: Dict[str, object] = {}
        self._lock = threading.Lock()

    def spawn(self) -> str:
        from presto_tpu_torch.server.worker import WorkerServer

        w = WorkerServer(
            coordinator_uri=self.coordinator_uri,
            catalogs=self.catalogs,
            config=self.config,
            preemptible=self.preemptible,
            device=self.device,
        ).start()
        with self._lock:
            self.workers[w.node_id] = w
        return w.node_id

    def drain(self, node_id: str) -> None:
        with self._lock:
            w = self.workers.pop(node_id, None)
        if w is None:
            return  # already gone (preempted/killed): a no-op drain
        threading.Thread(target=w.drain, daemon=True).start()

    def owns(self, node_id: str) -> bool:
        """Still drainable by this provider: tracked AND not already
        shutting down (a preempted/crashed in-process worker flips
        `_shutting_down`, so the autoscaler may forget it; a worker
        merely slow to announce stays owned)."""
        with self._lock:
            w = self.workers.get(node_id)
        return w is not None and not getattr(w, "_shutting_down", False)


def launch(etc_dir: str, device=None):
    """Boot the node this etc/ describes on ``device`` (None: the CUDA
    device); returns the running server (CoordinatorServer or
    WorkerServer). A coordinator config with ``pool.max-workers`` set
    additionally attaches the local pool provider (its workers on the
    same device) and starts the autoscaler (elastic worker pool)."""
    from presto_tpu_torch.server.coordinator import CoordinatorServer
    from presto_tpu_torch.server.worker import WorkerServer

    config, catalogs = load_etc(etc_dir)
    port = int(config.get("http-server.port", 0) or 0)
    if config.get("coordinator", False):
        # optional weighted-fair resource groups (reference:
        # etc/resource-groups.json file-configured manager)
        rg_path = os.path.join(etc_dir, "resource-groups.json")
        server: object = CoordinatorServer(
            port=port,
            catalogs=catalogs,
            config=config,
            resource_groups=rg_path if os.path.exists(rg_path) else None,
            device=device,
        ).start()
        if int(config.get("pool.max-workers", 0) or 0) > 0:
            server.attach_pool(
                LocalWorkerPoolProvider(
                    server.uri, config=config, catalogs=catalogs,
                    device=device,
                )
            )
    else:
        disc = config.get("discovery.uri")
        if not disc:
            raise ValueError(
                "worker config requires discovery.uri "
                "(the coordinator's address)"
            )
        server = WorkerServer(
            port=port,
            catalogs=catalogs,
            coordinator_uri=disc,
            node_id=config.get("node.id"),
            config=config,
            device=device,
        ).start()
    return server


def install_signal_handlers(server, exit=sys.exit):
    """SIGTERM/SIGINT -> graceful drain (rolling-restart protocol).

    A worker drains: it stops accepting tasks, announces ``DRAINING``
    (the coordinator stops scheduling to it), finishes + serves/spools
    its running outputs, then exits clean — a rolling restart under
    live load loses zero queries. A PREEMPTIBLE worker treats SIGTERM
    as the preemption notice (``preempt``: the same drain under the
    short ``pool.preempt-grace-s`` window — cloud preemptions don't
    wait out a full drain grace). A coordinator (no ``drain``) falls
    back to its ordinary shutdown. Returns the installed handler so
    tests can invoke and assert it directly."""

    def handler(signum, frame):
        name = signal.Signals(signum).name
        print(f"{name}: draining before exit", flush=True)
        drain = getattr(server, "drain", None)
        if getattr(server, "preemptible", False):
            drain = getattr(server, "preempt", drain)
        try:
            if drain is not None:
                drain()
            else:
                server.shutdown()
        finally:
            exit(0)

    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, handler)
    except ValueError:
        # signal handlers only install from the main thread; an
        # embedded (threaded) launch still gets the drain-aware main
        # loop, just not signal wiring
        pass
    return handler


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(
        description="presto-tpu node launcher (config-file bootstrap)"
    )
    ap.add_argument("--etc-dir", default="etc")
    args = ap.parse_args(argv)
    server = launch(args.etc_dir)
    kind = type(server).__name__
    print(f"{kind} listening on {server.uri}", flush=True)
    # SIGTERM (rolling restarts) and SIGINT (Ctrl-C during tests) both
    # drain gracefully instead of leaving workers undrained
    install_signal_handlers(server)
    import time

    # exit when the server shuts down, signal or not: a worker drained
    # over HTTP (PUT /v1/state/drain) must end the PROCESS — a rolling
    # restart waits on exactly that, and a sleeping zombie would hang it
    while not getattr(server, "_shutting_down", False):
        time.sleep(0.5)
    print(f"{kind} exited", flush=True)


if __name__ == "__main__":
    main()
