"""Unified RPC plane for every coordinator<->worker<->client HTTP call.

Reference parity: presto routes all intra-cluster traffic through one
airlift HttpClient with per-client config-driven timeouts, and treats
node failure detection / recoverable execution as coordinator duties
(SURVEY.md §2.5, §5.3). Here the single helper replaces the ad-hoc
``urllib.request.urlopen`` call sites (``tools/check_rpc_calls.py``
enforces that) and adds what raw urlopen lacks:

- per-call, config-driven timeouts on a **monotonic** clock, with a
  connect bounded apart from the read (``CONNECT_TIMEOUT_S``), so a
  dead peer whose port leaves connects unanswered costs that bound, not
  a whole request timeout,
- bounded retries with exponential backoff + **full jitter** for
  connection-level failures on idempotent calls, and on a POST only
  when its connect failed (no byte of it was sent; a POST that reached
  its peer is never retried here — task creation is made idempotent
  one level up, where the coordinator mints a fresh task id per
  attempt),
- fault-plane hooks (:mod:`presto_tpu_torch.utils.faults`) before every
  attempt, so chaos tests inject at the one choke point,
- ``rpc.*`` metrics (requests / failures / retries / time).

The module also owns :class:`CircuitBreaker` — per-peer health memory
(CLOSED -> OPEN after N consecutive failures -> one HALF_OPEN probe ->
CLOSED) that the coordinator keys by worker node id and folds into
scheduling next to the discovery TTL.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import random
import threading
import time
import urllib.error
import urllib.request
from typing import List, Optional

from presto_tpu_torch.utils import faults
from presto_tpu_torch.utils.metrics import REGISTRY

#: connection-level failures eligible for retry. ``TimeoutError`` and
#: ``socket.timeout`` are OSErrors; ``HTTPError`` is excluded by
#: :func:`is_retryable` — the server answered, so re-sending cannot
#: change the outcome.
RETRYABLE_EXCS = (urllib.error.URLError, ConnectionError, OSError)

#: backoff jitter source when no seeded fault plane is active
_RNG = random.Random()


def backoff_rng() -> random.Random:
    """Full-jitter RNG: the fault plane's dedicated backoff stream
    when chaos is configured (deterministic schedules for seeded,
    single-threaded draws — concurrent threads still interleave),
    else the module default."""
    plane = faults.active()
    return plane.backoff_rng if plane is not None else _RNG


def is_retryable(exc: BaseException) -> bool:
    """Connection-level failure (dead socket, refused, timed out) —
    NOT an HTTP error response, which is an answer, not a failure."""
    return isinstance(exc, RETRYABLE_EXCS) and not isinstance(
        exc, urllib.error.HTTPError
    )


def is_task_recoverable(exc: BaseException) -> bool:
    """A failure that means the PEER cannot own the task rather than
    the task itself failing: any connection-level failure, a 404 on a
    task endpoint (the worker crashed + restarted under the same URI
    and lost the task), or a 503 (the worker is DRAINING and rejects
    new tasks). Recoverable by rescheduling on another worker; every
    other HTTP error is an execution failure that would fail anywhere."""
    if is_retryable(exc):
        return True
    return isinstance(exc, urllib.error.HTTPError) and exc.code in (
        404,
        503,
    )


#: the bound of a TCP connect: a live peer on a LAN accepts in well under
#: a second, a dead one may leave the connect unanswered
CONNECT_TIMEOUT_S = 3.0


@dataclasses.dataclass(frozen=True)
class RpcPolicy:
    """Per-call knobs, config-driven (reference: airlift HttpClient
    config keys)."""

    timeout_s: float = 30.0
    retries: int = 2
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    #: token-acked page-pull requests kept in flight per pull loop
    #: (``rpc.pull-depth``): 1 = strict request->ack->request; 2+
    #: overlaps the next page's network round trip with this page's
    #: deserialization (see :func:`pull_pages`)
    pull_depth: int = 2

    @staticmethod
    def from_config(config) -> "RpcPolicy":
        """Policy from NodeConfig ``rpc.*`` keys (defaults preserve the
        previously hardcoded 30 s request timeout)."""
        if config is None:
            return RpcPolicy()
        return RpcPolicy(
            timeout_s=float(config.get("rpc.request-timeout-s", 30.0)),
            retries=int(config.get("rpc.retries", 2)),
            backoff_base_s=float(config.get("rpc.backoff-base-s", 0.05)),
            backoff_max_s=float(config.get("rpc.backoff-max-s", 2.0)),
            pull_depth=int(config.get("rpc.pull-depth", 2)),
        )


DEFAULT_POLICY = RpcPolicy()


class _Connection(http.client.HTTPConnection):
    """An HTTP connection whose connect is bounded by
    ``CONNECT_TIMEOUT_S``: the socket then takes the request's timeout
    for every read. A connect that fails is marked ``unsent`` (no byte
    of the request left), which lets :func:`call` retry even a POST."""

    def connect(self) -> None:
        read_timeout = self.timeout
        self.timeout = min(CONNECT_TIMEOUT_S, read_timeout)
        try:
            super().connect()
        except OSError as e:
            e.unsent = True
            raise
        finally:
            self.timeout = read_timeout
        self.sock.settimeout(read_timeout)


class _Handler(urllib.request.HTTPHandler):
    def http_open(self, req):
        return self.do_open(_Connection, req)


_OPENER = urllib.request.build_opener(_Handler())


def _unsent(exc: BaseException) -> bool:
    """Did ``exc`` end the call before any byte of it was sent?"""
    reason = getattr(exc, "reason", exc)
    return bool(getattr(reason, "unsent", False))


#: shared executor for pipelined page pulls: one process-wide pool
#: instead of a fresh ThreadPoolExecutor per pull (no thread churn per
#: task stream). Speculative fetches are plain bounded-timeout GETs —
#: no inter-future dependencies, so a shared pool cannot deadlock;
#: abandoned fetches finish within the rpc timeout and their results
#: are dropped.
_PULL_POOL = None
_PULL_POOL_LOCK = threading.Lock()
_PULL_POOL_WORKERS = 32


def _pull_executor():
    global _PULL_POOL
    with _PULL_POOL_LOCK:
        if _PULL_POOL is None:
            from concurrent.futures import ThreadPoolExecutor

            _PULL_POOL = ThreadPoolExecutor(
                max_workers=_PULL_POOL_WORKERS,
                thread_name_prefix="page-pull",
            )
        return _PULL_POOL


def compute_backoff(
    attempt: int,
    policy: RpcPolicy = DEFAULT_POLICY,
    rng: Optional[random.Random] = None,
) -> float:
    """Exponential backoff with full jitter: uniform(0, min(cap,
    base * 2^attempt)). Full jitter (vs equal or none) de-correlates
    retry storms from many callers hitting one recovering peer."""
    cap = min(
        policy.backoff_max_s, policy.backoff_base_s * (2.0 ** attempt)
    )
    return (rng or backoff_rng()).uniform(0.0, cap)


@dataclasses.dataclass
class RpcResponse:
    """One successful HTTP exchange (2xx, including bodyless 204)."""

    status: int
    headers: object  # email.message.Message: case-insensitive .get
    body: bytes

    def json(self) -> dict:
        return json.loads(self.body) if self.body else {}


def call(
    method: str,
    url: str,
    body: Optional[bytes] = None,
    *,
    policy: RpcPolicy = DEFAULT_POLICY,
    timeout_s: Optional[float] = None,
    headers=None,
    traceparent: str = "",
    idempotent: Optional[bool] = None,
) -> RpcResponse:
    """One RPC with bounded retries.

    Retries apply only to connection-level failures, and only to
    idempotent calls (default: every method but POST) or to a call
    whose connect failed before it sent a byte — an HTTP error
    status or an application exception propagates immediately. Sleeps
    between attempts follow :func:`compute_backoff`.
    """
    if idempotent is None:
        idempotent = method != "POST"
    hdrs = dict(headers or ())
    if traceparent:
        hdrs["traceparent"] = traceparent
    timeout = policy.timeout_s if timeout_s is None else timeout_s
    attempts = policy.retries + 1
    last: Optional[BaseException] = None
    for attempt in range(attempts):
        if attempt:
            REGISTRY.counter("rpc.retries").update()
            time.sleep(compute_backoff(attempt - 1, policy))
        try:
            faults.maybe_inject_rpc(method, url)
            req = urllib.request.Request(
                url, data=body, method=method, headers=hdrs
            )
            with REGISTRY.timer("rpc.time").time():
                with _OPENER.open(req, timeout=timeout) as r:
                    out = RpcResponse(r.status, r.headers, r.read())
            REGISTRY.counter("rpc.requests").update()
            return out
        except Exception as e:
            REGISTRY.counter("rpc.failures").update()
            last = e
            if not (is_retryable(e) and (idempotent or _unsent(e))):
                raise
    assert last is not None
    raise last


def call_json(method: str, url: str, obj=None, **kw) -> dict:
    """JSON-in/JSON-out convenience over :func:`call`."""
    hdrs = dict(kw.pop("headers", None) or ())
    hdrs.setdefault("Content-Type", "application/json")
    body = json.dumps(obj).encode() if obj is not None else None
    return call(method, url, body, headers=hdrs, **kw).json()


def pull_pages(
    uri: str,
    task_id: str,
    buffer: int,
    *,
    policy: RpcPolicy = DEFAULT_POLICY,
    deadline_s: float = 3600.0,
    traceparent: str = "",
    stall=None,
    timeout_msg: str = "",
    depth: Optional[int] = None,
) -> list:
    """The token-acked exchange pull loop (one implementation for the
    coordinator's gather and the worker's shuffle read): GET
    ``/v1/task/{id}/results/{buffer}/{token}`` until ``X-Complete``,
    advancing the token per ``X-Next-Token``. Returns the deserialized
    pages.

    Pipelining (``depth``, default ``policy.pull_depth``): up to
    ``depth`` token requests stay in flight concurrently, so page
    N+1's network round trip overlaps page N's decompress/deserialize
    instead of strictly alternating. Every request carries an
    ``X-Ack`` header with the CONSUMED floor — the producer frees only
    pages the puller has actually received, so a speculative in-flight
    request can never free an unconsumed page (with depth 1 the floor
    equals the requested token, the historical ack-via-URL behavior).

    ``stall()`` runs when no page is ready yet (default: short sleep);
    callers use it to poll task status and surface failures. The
    deadline is monotonic."""
    from presto_tpu_torch.server import pages_wire

    depth = max(1, policy.pull_depth if depth is None else int(depth))
    out: list = []
    deadline = time.monotonic() + deadline_s

    def fetch(t: int, ack: int) -> RpcResponse:
        return call(
            "GET",
            f"{uri}/v1/task/{task_id}/results/{buffer}/{t}",
            policy=policy,
            traceparent=traceparent,
            headers={"X-Ack": str(ack)},
        )

    def timed_out() -> bool:
        return time.monotonic() > deadline

    def fail_timeout():
        raise TimeoutError(
            timeout_msg or f"pull of {task_id}[{buffer}] timed out"
        )

    token = 0
    if depth == 1:
        while True:
            if timed_out():
                fail_timeout()
            resp = fetch(token, token)
            complete = resp.headers.get("X-Complete") == "true"
            nxt = int(resp.headers.get("X-Next-Token", token))
            if resp.status == 200:
                out.append(pages_wire.deserialize_page(resp.body))
            if complete and nxt == token + (
                1 if resp.status == 200 else 0
            ):
                return out
            if nxt == token and resp.status != 200:
                if stall is not None:
                    stall()
                else:
                    time.sleep(0.02)
            token = nxt
        # not reached

    inflight: dict = {}
    executor = _pull_executor()
    try:
        while True:
            if timed_out():
                fail_timeout()
            # keep the window full: tokens [consumed, consumed+depth)
            for t in range(token, token + depth):
                if t not in inflight:
                    inflight[t] = executor.submit(fetch, t, token)
            resp = inflight.pop(token).result()
            complete = resp.headers.get("X-Complete") == "true"
            if resp.status == 200:
                out.append(pages_wire.deserialize_page(resp.body))
                token += 1
                if complete:
                    # that was the final page
                    return out
                continue
            # 204: no page at this token (a speculative response may
            # be stale — re-request rather than trusting it)
            if complete:
                return out
            if stall is not None:
                stall()
            else:
                time.sleep(0.02)
    finally:
        for f in inflight.values():
            f.cancel()


class CircuitBreaker:
    """Per-peer health memory (consecutive-failure scoring).

    CLOSED counts consecutive connection-level failures; at
    ``threshold`` the circuit OPENs and :meth:`allow` excludes the peer
    for ``open_s`` seconds (monotonic clock — wall jumps cannot reopen
    or pin it). After that, HALF_OPEN admits ONE probe: probe success
    re-CLOSEs, probe failure re-OPENs. A granted probe that never
    resolves (its query died elsewhere) re-arms after another
    ``open_s``, so a lost probe cannot wedge the breaker.

    ``transitions`` records every state change in order — the
    OPEN -> HALF_OPEN -> CLOSED cycle asserted by the chaos suite.
    """

    def __init__(self, threshold: int = 3, open_s: float = 5.0):
        self.threshold = threshold
        self.open_s = open_s
        self.state = "CLOSED"
        self.transitions: List[str] = []
        self._fails = 0
        self._opened = 0.0
        self._probe_at = 0.0
        self._lock = threading.Lock()

    def _to(self, state: str) -> bool:
        if state == self.state:
            return False
        self.state = state
        self.transitions.append(state)
        return True

    def peek(self) -> str:
        """Current state, without consuming a probe slot."""
        with self._lock:
            return self.state

    def allow(self) -> bool:
        """May this peer be scheduled to right now? OPEN -> HALF_OPEN
        promotion and probe-slot accounting happen here."""
        with self._lock:
            if self.state == "CLOSED":
                return True
            now = time.monotonic()
            if (
                self.state == "OPEN"
                and now - self._opened >= self.open_s
            ):
                self._to("HALF_OPEN")
                self._probe_at = 0.0
            if self.state == "HALF_OPEN" and (
                self._probe_at == 0.0
                or now - self._probe_at >= self.open_s
            ):
                self._probe_at = now
                return True
            return False

    def record_success(self) -> bool:
        """True when this success CLOSEd a half-open circuit."""
        with self._lock:
            self._fails = 0
            self._probe_at = 0.0
            return self._to("CLOSED")

    def record_failure(self) -> bool:
        """True when this failure OPENed the circuit."""
        with self._lock:
            self._fails += 1
            if self.state == "HALF_OPEN" or (
                self.state == "CLOSED" and self._fails >= self.threshold
            ):
                self._opened = time.monotonic()
                self._probe_at = 0.0
                return self._to("OPEN")
            return False
