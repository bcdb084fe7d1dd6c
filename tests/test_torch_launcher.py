"""The port's config-file bootstrap (``presto_tpu_torch.server.launcher``),
following the reference's ``tests/test_launcher.py``: ``etc/``
directories boot real coordinator and worker nodes (``device="cpu"``
here; ``python -m presto_tpu_torch.server.launcher --etc-dir DIR`` boots
on the card), with the ``tpch``, ``tpcds``, ``memory``, ``parquet`` and
``hive`` catalogs. An ``etc/`` that names a connector the port does not
have fails fast instead of skipping the catalog."""

from __future__ import annotations

import shutil
import signal
import time
from pathlib import Path

import pytest

from presto_tpu_torch.server import PrestoTpuClient
from presto_tpu_torch.server.launcher import (
    install_signal_handlers,
    launch,
    load_etc,
    parse_properties,
)
from torch_parity import one_torch_thread  # noqa: F401

REPO_ETC = Path(__file__).resolve().parent.parent / "etc"


def _write_etc(tmp_path, name, config_lines, catalogs=None):
    etc = tmp_path / name
    (etc / "catalog").mkdir(parents=True)
    (etc / "config.properties").write_text("\n".join(config_lines) + "\n")
    for cat, lines in (catalogs or {}).items():
        (etc / "catalog" / f"{cat}.properties").write_text(
            "\n".join(lines) + "\n"
        )
    return str(etc)


def test_parse_properties(tmp_path):
    p = tmp_path / "x.properties"
    p.write_text("# comment\n\na=1\nb = two words \n")
    assert parse_properties(str(p)) == {"a": "1", "b": "two words"}


def test_malformed_property_line_fails(tmp_path):
    p = tmp_path / "x.properties"
    p.write_text("a=1\nnot a pair\n")
    with pytest.raises(ValueError, match="expected key=value"):
        parse_properties(str(p))


def test_unknown_config_key_fails_fast(tmp_path):
    etc = _write_etc(tmp_path, "bad", ["coordinator=true", "no.such.key=1"])
    with pytest.raises(KeyError, match="no.such.key"):
        load_etc(etc)


def test_catalog_requires_connector_name(tmp_path):
    etc = _write_etc(
        tmp_path, "badcat", ["coordinator=true"], {"broken": ["foo=1"]}
    )
    with pytest.raises(ValueError, match="connector.name"):
        load_etc(etc)


def test_missing_config_fails(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_etc(str(tmp_path / "nowhere"))


def test_repo_etc_fails_fast_on_a_connector_not_ported_yet(tmp_path):
    """The repo's own ``etc/`` mounts every catalog, its ``parquet`` and
    ``hive`` ones among them; a connector name the port does not have
    still fails fast."""
    _config, catalogs = load_etc(str(REPO_ETC))
    assert sorted(catalogs.names()) == sorted(
        ["lake", "memory", "tpcds", "tpch", "warehouse"]
    )
    assert type(catalogs.get("lake")).__name__ == "ParquetConnector"
    assert type(catalogs.get("warehouse")).__name__ == "HiveConnector"
    etc = _write_etc(
        tmp_path, "unknown", ["coordinator=true"],
        {"odd": ["connector.name=no-such-connector"]},
    )
    with pytest.raises(KeyError, match="unknown connector: no-such-connector"):
        load_etc(etc)


def test_hive_catalog_fails_fast(tmp_path):
    """A hive catalog mounts over a partitioned warehouse (``root=``)
    and answers a query through it."""
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    from presto_tpu_torch.exec.local_runner import LocalQueryRunner

    wh = tmp_path / "wh"
    for region, vals in (("east", [1, 2, 3]), ("west", [4, 5])):
        part = wh / "sales" / "events" / f"region={region}"
        part.mkdir(parents=True)
        pq.write_table(pa.table({"v": vals}), str(part / "000.parquet"))
    etc = tmp_path / "hive"
    shutil.copytree(REPO_ETC, etc)
    (etc / "catalog" / "lake.properties").unlink()
    (etc / "catalog" / "warehouse.properties").write_text(
        f"connector.name=hive\nroot={wh}\n"
    )
    _config, catalogs = load_etc(str(etc))
    runner = LocalQueryRunner(catalogs=catalogs, device="cpu")
    assert runner.execute(
        "select region, sum(v) as s from warehouse.sales.events "
        "group by region order by region"
    ).rows() == [("east", 6), ("west", 9)]


def test_worker_config_requires_discovery(tmp_path):
    etc = _write_etc(tmp_path, "w", ["coordinator=false"])
    with pytest.raises(ValueError, match="discovery.uri"):
        launch(etc, device="cpu")


def test_launch_cluster_from_etc(tmp_path):
    cats = {
        "tpch": ["connector.name=tpch"],
        "tpcds": ["connector.name=tpcds"],
        "mem": ["connector.name=memory"],
    }
    coord_etc = _write_etc(
        tmp_path, "coord",
        ["coordinator=true", "query.max-memory-per-node=2GB",
         "staging.cache-bytes=64MB"],
        cats,
    )
    coord = launch(coord_etc, device="cpu")
    try:
        assert coord.memory_pool.limit == 2 << 30
        assert coord.local.split_cache.budget == 64 << 20
        for cat in cats:
            assert coord.local.catalogs.has(cat)
        worker_etc = _write_etc(
            tmp_path, "worker",
            ["coordinator=false", f"discovery.uri={coord.uri}",
             "node.id=etc-worker"],
            cats,
        )
        worker = launch(worker_etc, device="cpu")
        try:
            deadline = time.time() + 10
            while time.time() < deadline and not coord.active_workers():
                time.sleep(0.05)
            assert [w.node_id for w in coord.active_workers()] == [
                "etc-worker"
            ]
            client = PrestoTpuClient(coord.uri, timeout_s=120)
            assert client.execute(
                "select count(*) as c from tpch.tiny.region"
            ).rows() == [(5,)]
            assert client.execute(
                "select count(*) as c from tpcds.tiny.store"
            ).rows()[0][0] > 0
            # memory catalogs are per node, as in the reference
            assert worker.runner.catalogs.has("mem")
        finally:
            worker.shutdown(graceful=False)
    finally:
        coord.shutdown()


class _FakeNode:
    def __init__(self, drains: bool):
        self.calls = []
        if drains:
            self.drain = lambda: self.calls.append("drain")

    def shutdown(self):
        self.calls.append("shutdown")


@pytest.mark.parametrize("drains", [True, False], ids=["worker", "coordinator"])
def test_signal_handler_drains_then_exits(drains):
    node = _FakeNode(drains)
    exits = []
    prev = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        handler = install_signal_handlers(node, exit=exits.append)
        handler(signal.SIGTERM, None)
    finally:
        for s, h in prev.items():
            signal.signal(s, h)
    assert node.calls == ["drain" if drains else "shutdown"]
    assert exits == [0]
