"""Wire protocol: plan/expression trees and task specs as JSON.

Reference parity: the coordinator->worker task protocol — a
``PlanFragment`` serialized as JSON plus split batches, exactly the
boundary where the reference swaps execution backends (SURVEY.md
preamble, §2.3 "presto_protocol" codegen'd structs, §3.2).

Implementation: a generic tagged codec over the engine's frozen
dataclasses (plan nodes, expressions, types, agg/sort/window calls,
table handles, splits). Every object encodes as
``{"@": "ClassName", ...fields}``; tuples encode as lists and are
restored per-field from dataclass annotations at decode time — the
registry below is the single source of which classes may appear on the
wire (arbitrary class instantiation from JSON is not possible).
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict, List

from presto_tpu_torch import expr as E
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.spi import (
    ConnectorSplit,
    RangeSet,
    TableHandle,
)
from presto_tpu_torch.ops.aggregation import AggCall
from presto_tpu_torch.ops.sort import SortKey
from presto_tpu_torch.ops.window import WindowCall
from presto_tpu_torch.plan import nodes as N


def _registry() -> Dict[str, type]:
    classes: List[type] = [TableHandle, ConnectorSplit, RangeSet,
                           AggCall, SortKey, WindowCall]
    for mod in (E, T, N):
        for name in dir(mod):
            obj = getattr(mod, name)
            if isinstance(obj, type) and dataclasses.is_dataclass(obj):
                classes.append(obj)
    return {c.__name__: c for c in classes}


_REGISTRY = _registry()

#: singleton DataType instances by type name (decimal carries params)
_TYPE_SINGLETONS = {
    t.name: t
    for t in [
        T.BIGINT, T.INTEGER, T.DOUBLE, T.REAL, T.BOOLEAN, T.VARCHAR,
        T.DATE, T.TIMESTAMP,
    ]
}


def encode(obj: Any) -> Any:
    """Engine object -> JSON-able structure."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, T.DataType):
        if obj.is_array:
            return {"@": "array", "element": encode(obj.element)}
        if obj.is_decimal:
            return {"@": "decimal", "p": obj.precision, "s": obj.scale}
        if isinstance(obj, T.VarcharType) and obj.length is not None:
            # parameterized varchar(n)/char(n): name not in singletons
            return {"@": "varchar", "len": obj.length}
        return {"@": "type", "name": obj.name}
    if isinstance(obj, (tuple, list)):
        return [encode(x) for x in obj]
    if dataclasses.is_dataclass(obj):
        cls = type(obj)
        if cls.__name__ not in _REGISTRY:
            raise TypeError(f"{cls.__name__} is not wire-registered")
        out = {"@": cls.__name__}
        for f in dataclasses.fields(obj):
            if f.name == "fn" and isinstance(
                obj, (E.DictTransform, E.DictPredicate, E.DictIntFunc,
                      E.DictCombine, E.IntToDict)
            ):
                # host callables don't cross the wire: fn_key is the
                # canonical identity, rebuilt at decode time
                continue
            out[f.name] = encode(getattr(obj, f.name))
        return out
    raise TypeError(f"cannot encode {type(obj).__name__}")


def decode(data: Any) -> Any:
    """JSON structure -> engine object."""
    if data is None or isinstance(data, (bool, int, float, str)):
        return data
    if isinstance(data, list):
        return tuple(decode(x) for x in data)
    tag = data.get("@")
    if tag == "array":
        return T.array(decode(data["element"]))
    if tag == "decimal":
        return T.decimal(data["p"], data["s"])
    if tag == "varchar":
        return T.varchar(data["len"])
    if tag == "type":
        return _TYPE_SINGLETONS[data["name"]]
    cls = _REGISTRY.get(tag)
    if cls is None:
        raise TypeError(f"unknown wire tag {tag!r}")
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name in data:
            kwargs[f.name] = _coerce(decode(data[f.name]), f.type, cls)
    if (
        cls in (E.DictTransform, E.DictPredicate, E.DictIntFunc,
            E.DictCombine, E.IntToDict)
        and "fn" not in kwargs
    ):
        kwargs["fn"] = E.dict_transform_fn(kwargs["fn_key"])
    return cls(**kwargs)


def _coerce(value: Any, annot: Any, cls: type) -> Any:
    """Tuples come back as tuples already; lists in annotations stay
    tuples (engine convention: all plan/expr collections are tuples)."""
    return value


# ----------------------------------------- prepared-statement headers
#
# Reference parity: the client protocol's prepared-statement session
# headers — the CLIENT owns the prepared map and replays it on every
# request (the coordinator is stateless across requests):
#
#   request:  X-Presto-Prepared-Statement: name=<urlencoded sql>[, ...]
#   response: X-Presto-Added-Prepare: name=<urlencoded sql>  (PREPARE)
#             X-Presto-Deallocated-Prepare: name           (DEALLOCATE)
#
# EXECUTE then reaches the coordinator's plan-cache fast lane with the
# statement text supplied by the header — zero server-side session
# state, warm shapes skip planning and compilation entirely.

PREPARED_STATEMENT_HEADER = "X-Presto-Prepared-Statement"
ADDED_PREPARE_HEADER = "X-Presto-Added-Prepare"
DEALLOCATED_PREPARE_HEADER = "X-Presto-Deallocated-Prepare"


def encode_prepared(name: str, sql: str) -> str:
    import urllib.parse

    return f"{name}={urllib.parse.quote(sql, safe='')}"


def decode_prepared(header_values) -> Dict[str, str]:
    """Parse one or more ``name=<urlencoded sql>`` header values
    (comma-separated within a value; quoting escapes commas)."""
    import urllib.parse

    out: Dict[str, str] = {}
    for value in header_values or ():
        for part in value.split(","):
            part = part.strip()
            if not part or "=" not in part:
                continue
            name, enc = part.split("=", 1)
            out[name.strip()] = urllib.parse.unquote(enc.strip())
    return out


# ------------------------------------------------------------ task spec


@dataclasses.dataclass(frozen=True)
class FragmentSpec:
    """One task: a plan fragment + the splits this worker owns.

    ``partition_scan`` names the scan (by walk index) whose splits are
    sharded across workers; every other scan is replicated (scanned in
    full by each worker) — the reference's source-partitioned stage vs
    replicated build sides (SURVEY.md §2.4).
    """

    task_id: str
    query_id: str
    fragment: N.PlanNode
    partition_scan: int  # walk index of the partitioned TableScanNode
    split_start: int  # row range of the partitioned scan owned here
    split_end: int
    #: rows per split batch streamed through the compiled fragment
    #: (session ``page_capacity``; 0 = the whole range in one batch).
    #: Safe because the coordinator's FINAL step merges partial states,
    #: so per-batch partials concatenate like per-worker partials.
    split_batch_rows: int = 0
    #: concurrent split-batch drivers per task (session
    #: ``task_concurrency``; reference: task.concurrency driver count)
    task_concurrency: int = 1
    #: split batches prefetch-staged ahead of device execution
    #: (session ``staging_prefetch_depth``; -1 = unset — the worker
    #: falls back to its own session/config default)
    prefetch_depth: int = -1
    #: partitioned output (reference: PartitionedOutputOperator +
    #: PartitionedOutputBuffer): producers hash-partition output rows by
    #: ``partition_keys`` into ``n_partitions`` buffers; downstream
    #: merge tasks pull only their buffer — worker<->worker shuffle,
    #: pages never touch the coordinator
    n_partitions: int = 1
    partition_keys: tuple = ()
    #: merge task (reference: an intermediate stage's ExchangeClient):
    #: ``sources`` = [(uri, task_id), ...] of the producing stage;
    #: ``partition`` = which output buffer this merge task owns. When
    #: sources is non-empty the fragment's leaf is a RemoteSourceNode
    #: fed by the pulled pages instead of a table scan.
    sources: tuple = ()
    partition: int = 0
    #: dynamic-filter SUMMARY task (exec/dynfilter.py): instead of
    #: emitting result pages, the worker summarizes the named output
    #: columns (the join's build keys) of every batch — min/max +
    #: small distinct sets, NDV-capped at ``dynfilter_ndv`` — merges
    #: them, and reports the summary on the task-status response
    dynfilter_keys: tuple = ()
    dynfilter_ndv: int = 0
    #: fault-tolerant execution (session ``retry_policy`` TASK/QUERY
    #: with ``exchange.spool-path`` configured): the worker tees this
    #: task's partitioned output-buffer pages into the durable exchange
    #: spool (committed on FINISH), and a merge/join task whose
    #: upstream peer died re-serves that source's partition from the
    #: spool instead of failing (server.spool)
    spool: bool = False
    #: in-slice collective shuffle (server/exchange_spi.py): the slice
    #: id the SCHEDULER selected for this stage's exchange edges —
    #: producers whose own slice matches keep partitioned output
    #: device-resident in the ICI segment, and merge/join consumers
    #: gather their partition device-to-device instead of pulling
    #: serialized pages over HTTP. Empty = the HTTP wire (bit-exact
    #: legacy). A worker whose slice does NOT match (a retry landed
    #: cross-slice) silently uses HTTP; recovery and drain degrade the
    #: same way.
    ici_slice: str = ""
    #: trace context (utils.tracing traceparent header value): the
    #: coordinator stamps every task with the query's trace so
    #: worker-side spans join the query's span tree; also sent as the
    #: ``traceparent`` HTTP header on every coordinator->worker call
    traceparent: str = ""

    def to_json(self) -> dict:
        return {
            "task_id": self.task_id,
            "query_id": self.query_id,
            "fragment": encode(self.fragment),
            "partition_scan": self.partition_scan,
            "split_start": self.split_start,
            "split_end": self.split_end,
            "split_batch_rows": self.split_batch_rows,
            "task_concurrency": self.task_concurrency,
            "prefetch_depth": self.prefetch_depth,
            "n_partitions": self.n_partitions,
            "partition_keys": list(self.partition_keys),
            "sources": [list(s) for s in self.sources],
            "partition": self.partition,
            "dynfilter_keys": list(self.dynfilter_keys),
            "dynfilter_ndv": self.dynfilter_ndv,
            "spool": self.spool,
            "ici_slice": self.ici_slice,
            "traceparent": self.traceparent,
        }

    @staticmethod
    def from_json(d: dict) -> "FragmentSpec":
        return FragmentSpec(
            task_id=d["task_id"],
            query_id=d["query_id"],
            fragment=decode(d["fragment"]),
            partition_scan=d["partition_scan"],
            split_start=d["split_start"],
            split_end=d["split_end"],
            split_batch_rows=d.get("split_batch_rows", 0),
            task_concurrency=d.get("task_concurrency", 1),
            prefetch_depth=d.get("prefetch_depth", -1),
            n_partitions=d.get("n_partitions", 1),
            partition_keys=tuple(d.get("partition_keys", ())),
            sources=tuple(
                tuple(s) for s in d.get("sources", ())
            ),
            partition=d.get("partition", 0),
            dynfilter_keys=tuple(d.get("dynfilter_keys", ())),
            dynfilter_ndv=d.get("dynfilter_ndv", 0),
            spool=bool(d.get("spool", False)),
            ici_slice=d.get("ici_slice", ""),
            traceparent=d.get("traceparent", ""),
        )
