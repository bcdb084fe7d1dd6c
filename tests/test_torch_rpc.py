"""The port's RPC plane bounds a connect apart from its read.

A peer whose port takes no new connection (a killed in-process worker's
listener that nobody accepts on) must cost the connect bound
(``rpc.CONNECT_TIMEOUT_S``), not a whole request timeout; a peer that
accepts and answers slowly keeps the full read timeout. A POST whose
connect failed sent nothing, so it is retried; one that reached its
peer is not. Every peer listens on localhost."""

from __future__ import annotations

import socket
import threading
import time

import pytest

from presto_tpu_torch.server import WorkerServer, rpc
from presto_tpu_torch.server.protocol import FragmentSpec
from presto_tpu_torch.session import NodeConfig
from presto_tpu_torch.utils.metrics import REGISTRY


@pytest.fixture
def unaccepted_port():
    """A listener with a backlog of 0 that never accepts, its queue
    filled, so a further connect gets no answer."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(0)
    port = srv.getsockname()[1]
    fillers = []
    for _ in range(8):
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.settimeout(0.2)
        try:
            s.connect(("127.0.0.1", port))
        except OSError:
            pass
        fillers.append(s)
    probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    probe.settimeout(0.5)
    try:
        probe.connect(("127.0.0.1", port))
        hangs = False
    except OSError:
        hangs = True
    finally:
        probe.close()
    if not hangs:
        for s in fillers:
            s.close()
        srv.close()
        pytest.fail("the filled listener still took a connect")
    yield port
    for s in fillers:
        s.close()
    srv.close()


@pytest.fixture
def connect_bound(monkeypatch):
    """Sets ``rpc.CONNECT_TIMEOUT_S`` for one test."""

    def bound(seconds: float) -> None:
        monkeypatch.setattr(rpc, "CONNECT_TIMEOUT_S", seconds)

    return bound


@pytest.fixture
def slow_server():
    """An HTTP peer that accepts at once and answers after 1.5 s; it
    counts the connections it accepted (``accepted``)."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)
    stop = threading.Event()
    accepted = []

    def serve():
        srv.settimeout(0.1)
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except OSError:
                continue
            accepted.append(conn)
            with conn:
                conn.recv(65536)
                time.sleep(1.5)
                body = b'{"ok": true}'
                conn.sendall(
                    b"HTTP/1.1 200 OK\r\nContent-Type: application/json"
                    b"\r\nContent-Length: " + str(len(body)).encode()
                    + b"\r\nConnection: close\r\n\r\n" + body
                )

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    serve.port, serve.accepted = srv.getsockname()[1], accepted
    yield serve
    stop.set()
    t.join(5)
    srv.close()


def _retries() -> int:
    return REGISTRY.counter("rpc.retries").total


def test_unanswered_connect_fails_within_the_connect_timeout(
    unaccepted_port, connect_bound
):
    connect_bound(0.5)
    policy = rpc.RpcPolicy(timeout_s=30.0, retries=0)
    t0 = time.monotonic()
    with pytest.raises(OSError) as err:
        rpc.call(
            "GET", f"http://127.0.0.1:{unaccepted_port}/v1/info",
            policy=policy,
        )
    took = time.monotonic() - t0
    assert rpc.is_retryable(err.value)
    assert took < 5.0, f"connect took {took:.2f} s of a 0.5 s bound"


def test_slow_reply_keeps_the_full_read_timeout(slow_server, connect_bound):
    connect_bound(0.5)
    policy = rpc.RpcPolicy(timeout_s=10.0, retries=0)
    t0 = time.monotonic()
    out = rpc.call_json(
        "GET", f"http://127.0.0.1:{slow_server.port}/v1/info", policy=policy
    )
    assert out == {"ok": True}
    assert time.monotonic() - t0 >= 1.4


def test_read_timeout_still_bounds_a_slow_reply(slow_server, connect_bound):
    connect_bound(5.0)
    policy = rpc.RpcPolicy(timeout_s=0.5, retries=0)
    with pytest.raises(OSError):
        rpc.call(
            "GET", f"http://127.0.0.1:{slow_server.port}/v1/info",
            policy=policy,
        )


def test_connect_bound_is_the_policy_default(unaccepted_port, connect_bound):
    """Every policy, a node's from its config too, bounds the connect
    by ``CONNECT_TIMEOUT_S`` apart from its request timeout."""
    assert rpc.CONNECT_TIMEOUT_S == 3.0
    cfg = NodeConfig({"rpc.request-timeout-s": "120", "rpc.retries": "0"})
    policy = rpc.RpcPolicy.from_config(cfg)
    assert policy.timeout_s == 120.0
    connect_bound(0.5)
    t0 = time.monotonic()
    with pytest.raises(OSError):
        rpc.call(
            "GET", f"http://127.0.0.1:{unaccepted_port}/v1/info",
            policy=policy,
        )
    assert time.monotonic() - t0 < 5.0


def test_post_whose_connect_failed_is_retried(unaccepted_port, connect_bound):
    """No byte of the POST left, so each retry is safe: both are made
    and the call still fails within the three connect bounds."""
    connect_bound(0.3)
    policy = rpc.RpcPolicy(timeout_s=30.0, retries=2)
    before = _retries()
    t0 = time.monotonic()
    with pytest.raises(OSError) as err:
        rpc.call(
            "POST", f"http://127.0.0.1:{unaccepted_port}/v1/task", b"{}",
            policy=policy,
        )
    assert rpc.is_retryable(err.value)
    assert _retries() - before == 2
    assert time.monotonic() - t0 < 8.0


def test_post_that_reached_its_peer_is_not_retried(slow_server):
    """The POST was sent and its reply timed out: the peer may have
    acted on it, so it is not sent again."""
    policy = rpc.RpcPolicy(timeout_s=0.5, retries=2)
    before = _retries()
    with pytest.raises(OSError):
        rpc.call(
            "POST", f"http://127.0.0.1:{slow_server.port}/v1/task", b"{}",
            policy=policy,
        )
    assert _retries() == before
    deadline = time.monotonic() + 5.0
    while not slow_server.accepted and time.monotonic() < deadline:
        time.sleep(0.02)
    time.sleep(0.3)
    assert len(slow_server.accepted) == 1


def test_burst_of_task_posts_to_a_worker(connect_bound):
    """64 clients POST a task each at one instant to one worker: every
    POST is answered (none loses its connect to a full accept queue)
    and each made exactly one task."""
    connect_bound(0.5)
    n = 64
    worker = WorkerServer(device="cpu").start()
    policy = rpc.RpcPolicy(timeout_s=30.0, retries=0)
    gate = threading.Barrier(n)
    answers, errors = [], []

    def post(i: int) -> None:
        spec = FragmentSpec(
            task_id=f"q_burst.s.0.{i}", query_id="q_burst", fragment=None,
            partition_scan=0, split_start=0, split_end=0,
        )
        gate.wait()
        try:
            answers.append(rpc.call_json(
                "POST", worker.uri + "/v1/task", spec.to_json(),
                policy=policy,
            )["task_id"])
        except Exception as e:  # noqa: BLE001 - collected, asserted below
            errors.append(e)

    threads = [threading.Thread(target=post, args=(i,)) for i in range(n)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert errors == []
        assert sorted(answers) == sorted(
            f"q_burst.s.0.{i}" for i in range(n)
        )
        assert sorted(
            t for t in worker.tasks if t.startswith("q_burst.")
        ) == sorted(answers)
    finally:
        worker.shutdown(graceful=False)
