"""Client: drives the paged ``/v1/statement`` protocol.

Reference parity: the ``StatementClient`` inside ``presto-client/``
(SURVEY.md §1 L0) — submit SQL with one POST, then follow ``nextUri``
pages until the response carries no continuation, accumulating data
rows; surface server-side failures as exceptions.

Multi-coordinator HA: constructed with a LIST of coordinator URIs the
client SPRAYS statements round-robin, and on a connection-level
failure re-targets the SAME statement token at a peer — a coordinator
that failed over the query serves it by alias, any other live
coordinator redirects through its lease-payload lookup. A 404 from
EVERY coordinator means the alias chain is exhausted (nothing can
resume the statement) and fails the query immediately instead of
spinning the full reconnect budget. One URI keeps the legacy
single-coordinator behavior bit-exact.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
import urllib.error
from typing import Dict, List

from presto_tpu_torch.server import protocol, rpc
from presto_tpu_torch.utils.metrics import REGISTRY


class QueryFailed(RuntimeError):
    """The server reported the query FAILED."""


@dataclasses.dataclass
class ClientResult:
    """Materialized result of one statement."""

    query_id: str
    columns: List[str]
    data: List[list]

    def rows(self) -> List[tuple]:
        return [tuple(r) for r in self.data]


class PrestoTpuClient:
    """Minimal blocking client for one coordinator (or a spray list
    of peers — see the module docstring)."""

    def __init__(
        self,
        coordinator_uri,
        timeout_s: float = 120.0,
        user: str = "presto_tpu",
        rpc_policy: rpc.RpcPolicy = rpc.DEFAULT_POLICY,
        reconnect_attempts: int = 8,
    ):
        # one URI, a comma-separated string, or a sequence of URIs
        if isinstance(coordinator_uri, str):
            uris = [
                u.strip()
                for u in coordinator_uri.split(",")
                if u.strip()
            ]
        else:
            uris = [str(u).strip() for u in coordinator_uri]
        if not uris:
            raise ValueError("at least one coordinator URI required")
        #: spray set: statements round-robin across these; nextUri
        #: polls re-target across them on connection failure
        self.uris = [u.rstrip("/") for u in uris]
        #: first coordinator — the single-target compatibility handle
        #: (observability GETs and existing callers read it)
        self.uri = self.uris[0]
        self._rr = itertools.count(0)
        self.timeout_s = timeout_s
        self.user = user  # sent as X-Presto-User (resource-group routing)
        #: per-request policy: nextUri GETs are idempotent and retry
        #: with backoff; the statement POST never retries (resubmitting
        #: would start a second query)
        self.rpc_policy = rpc_policy
        #: transparent-reconnect budget across a coordinator BOUNCE:
        #: connection-level failures on nextUri GETs retry this many
        #: times with jittered backoff (on top of the rpc policy's own
        #: short retries) before surfacing — a restarted coordinator
        #: resumes journaled queries under the same statement URIs, so
        #: mid-pagination clients ride out the restart instead of dying
        #: on the first connection reset
        self.reconnect_attempts = max(int(reconnect_attempts), 0)
        #: prepared statements this client session owns (reference: the
        #: client protocol's prepared-statement session headers). The
        #: map replays on every request as X-Presto-Prepared-Statement
        #: headers and updates from the server's added/deallocated
        #: response headers — the coordinator stays stateless, and
        #: EXECUTE reaches its zero-recompile plan-cache fast lane.
        self.prepared: Dict[str, str] = {}
        #: memoized wire form of ``prepared`` (the header value every
        #: request replays): rebuilt only when the map MUTATES — a
        #: serving loop EXECUTEing one hot statement re-encodes
        #: nothing per request. None = dirty.
        self._prepared_header: Optional[str] = None

    def execute(self, sql: str) -> ClientResult:
        first = self._post_statement(sql.encode())
        qid = first["id"]
        columns: List[str] = []
        data: List[list] = []
        cur = first
        deadline = time.monotonic() + self.timeout_s
        while True:
            if "error" in cur:
                raise QueryFailed(cur["error"])
            if cur.get("columns"):
                columns = [c["name"] for c in cur["columns"]]
            data.extend(cur.get("data") or [])
            nxt = cur.get("nextUri")
            if not nxt:
                return ClientResult(query_id=qid, columns=columns, data=data)
            if time.monotonic() > deadline:
                raise TimeoutError(f"query {qid} did not finish in time")
            resp = self._get_with_reconnect(nxt, deadline)
            self._absorb_prepared_headers(resp.headers)
            cur = resp.json()
            # a SUSPENDED (QoS-parked) query answers polls immediately
            # with empty data + a Retry-After hint: honor it so the
            # poll loop idles gently instead of hammering the
            # coordinator until resume
            retry_after = resp.headers.get("Retry-After")
            if retry_after and not cur.get("data") and cur.get(
                "nextUri"
            ):
                try:
                    time.sleep(
                        min(
                            float(retry_after),
                            max(deadline - time.monotonic(), 0.0),
                            2.0,
                        )
                    )
                except ValueError:
                    pass

    def _post_statement(self, body: bytes) -> dict:
        """Submit one statement, spraying the coordinator list
        round-robin. A connection-level failure moves to the next peer
        (the POST was never delivered, so re-targeting starts no
        duplicate query); a 503 moves on too — the coordinator is
        shutting down and explicitly admitted NOTHING. Any other HTTP
        error response surfaces — the server answered, resubmitting
        elsewhere WOULD double-run."""
        start = next(self._rr) % len(self.uris)
        order = self.uris[start:] + self.uris[:start]
        for i, base in enumerate(order):
            try:
                return self._post_json(base + "/v1/statement", body)
            except Exception as e:
                refused = (
                    isinstance(e, urllib.error.HTTPError)
                    and e.code == 503
                )
                if (
                    not (refused or rpc.is_retryable(e))
                    or i + 1 >= len(order)
                ):
                    raise
                REGISTRY.counter("client.spray_retargets").update()
        raise AssertionError("unreachable")  # pragma: no cover

    def _spray_targets(self, url: str) -> List[str]:
        """The URL plus its rebase onto every other coordinator in the
        spray set (origin first — the server that minted it is the
        likeliest to answer). Single-coordinator: just the URL."""
        if len(self.uris) == 1:
            return [url]
        from urllib.parse import urlsplit

        parts = urlsplit(url)
        path = parts.path + (
            f"?{parts.query}" if parts.query else ""
        )
        origin = f"{parts.scheme}://{parts.netloc}"
        return [origin + path] + [
            b + path for b in self.uris if b != origin
        ]

    def _get_with_reconnect(self, url: str, deadline: float):
        """One nextUri GET with transparent reconnect: a coordinator
        bounce mid-pagination presents as connection resets/refusals,
        and the restarted coordinator serves the SAME statement URIs
        for journal-resumed queries — so connection-level failures
        retry with full-jitter backoff up to the reconnect budget. An
        HTTP error response (the server answered) and the query's own
        ``error`` payload surface immediately, as before.

        With a spray set, each attempt SWEEPS every coordinator: a
        peer that claimed the dead coordinator's journal serves the
        statement by alias, and any other live peer redirects to it.
        Two terminal verdicts are distinguished: "coordinator gone"
        (connection failure — re-target and, across sweeps, spend the
        reconnect budget) versus "statement gone" (404 from EVERY
        coordinator — the alias chain is exhausted, nothing can resume
        the query: fail NOW, not after the full backoff schedule)."""
        attempt = 0
        last_exc: Exception = None
        while True:
            targets = self._spray_targets(url)
            gone = 0
            for target in targets:
                try:
                    resp = rpc.call(
                        "GET", target, policy=self.rpc_policy
                    )
                    if target != url:
                        REGISTRY.counter("client.retargets").update()
                    return resp
                except urllib.error.HTTPError as e:
                    # the server ANSWERED. Only a 404 with peers left
                    # to consult means "ask another coordinator" —
                    # anything else is final, exactly as before
                    if e.code == 404 and len(targets) > 1:
                        gone += 1
                        last_exc = e
                        continue
                    raise
                except Exception as e:
                    if not rpc.is_retryable(e):
                        raise
                    last_exc = e
            if gone == len(targets):
                raise QueryFailed(
                    "statement gone on every coordinator "
                    f"(alias chain exhausted): {url}"
                )
            attempt += 1
            if (
                attempt > self.reconnect_attempts
                or time.monotonic() > deadline
            ):
                raise last_exc
            REGISTRY.counter("client.reconnects").update()
            time.sleep(
                rpc.compute_backoff(attempt - 1, self.rpc_policy)
            )

    def _absorb_prepared_headers(self, headers) -> None:
        added = headers.get_all(protocol.ADDED_PREPARE_HEADER)
        if added:
            # absorb once per (client, name): an echo of a statement
            # the map already carries verbatim must not dirty the
            # memoized request header (the common case — the server
            # echoes at most the first page, but a retried page read
            # can replay it)
            fresh = {
                n: s
                for n, s in protocol.decode_prepared(added).items()
                if self.prepared.get(n) != s
            }
            if fresh:
                self.prepared.update(fresh)
                self._prepared_header = None
        dropped = headers.get(protocol.DEALLOCATED_PREPARE_HEADER)
        if dropped and self.prepared.pop(dropped, None) is not None:
            self._prepared_header = None

    # ----------------------------------------------------- observability

    def query_info(self, query_id: str) -> dict:
        """Full QueryInfo for one query — the stats rollup (per-stage
        task timings) and the span tree (``GET /v1/query/{id}``)."""
        return self._get_json(f"{self.uri}/v1/query/{query_id}")

    def query_progress(self, query_id: str) -> dict:
        """Live progress for one query — per-stage splits done/total,
        rows/bytes/dispatch counters, and an ETA — consumable while
        the query is still RUNNING
        (``GET /v1/query/{id}/progress``)."""
        return self._get_json(
            f"{self.uri}/v1/query/{query_id}/progress"
        )

    def list_queries(self) -> List[dict]:
        """Summaries of every query the coordinator remembers
        (``GET /v1/query``)."""
        return self._get_json(f"{self.uri}/v1/query")

    # ------------------------------------------------------------ http

    def _post_json(self, url: str, body: bytes) -> dict:
        headers = {
            "Content-Type": "text/plain",
            "X-Presto-User": self.user,
        }
        if self.prepared:
            hdr = self._prepared_header
            if hdr is None:
                hdr = self._prepared_header = ",".join(
                    protocol.encode_prepared(n, s)
                    for n, s in self.prepared.items()
                )
            headers[protocol.PREPARED_STATEMENT_HEADER] = hdr
        return rpc.call(
            "POST", url, body,
            policy=self.rpc_policy,
            headers=headers,
        ).json()

    def _get_json(self, url: str) -> dict:
        return rpc.call("GET", url, policy=self.rpc_policy).json()
