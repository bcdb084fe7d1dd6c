"""The port's server wire against the JAX reference's, on the CPU.

What crosses a process boundary must be the same bytes in both
packages, so a mixed reference/port cluster can read either side:

- a ``FragmentSpec`` of Q1's, Q3's and Q18's worker fragments (planned,
  pruned and cut by each package) encodes to the same JSON;
- a seeded page of every flat type, a dictionary varchar and an array
  column serializes to the reference's frame byte for byte, and each
  package deserializes the other's frames to the same payload;
- the placement helpers (``assign_ranges``, ``select_exchange_transport``,
  ``select_exchange_edges``, ``stable_workers``), the partition slicing
  of the HTTP shuffle and the dynamic-filter summaries
  (``summarize_page``, the merge, ``to_predicate``, ``to_constraint``)
  give the reference's answers on the same inputs.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

from presto_tpu import page as ref_page
from presto_tpu import types as ref_types
from presto_tpu.exec import dynfilter as ref_df
from presto_tpu.exec import streaming as ref_streaming
from presto_tpu.exec.host_ops import peel_host_ops as ref_peel
from presto_tpu.exec.local_runner import LocalQueryRunner as RefRunner
from presto_tpu.parallel.fragmenter import insert_gathers as ref_gathers
from presto_tpu.plan import nodes as ref_nodes
from presto_tpu.plan.optimizer import prune_columns as ref_prune
from presto_tpu.server import exchange_spi as ref_spi
from presto_tpu.server import pages_wire as ref_wire
from presto_tpu.server import scheduler as ref_sched
from presto_tpu.server.protocol import FragmentSpec as RefSpec
from presto_tpu.sql import parse_statement as ref_parse
from presto_tpu_torch import page as port_page
from presto_tpu_torch import types as port_types
from presto_tpu_torch.exec import dynfilter as port_df
from presto_tpu_torch.exec import streaming as port_streaming
from presto_tpu_torch.exec.host_ops import peel_host_ops as port_peel
from presto_tpu_torch.exec.local_runner import LocalQueryRunner
from presto_tpu_torch.parallel.fragmenter import insert_gathers as port_gathers
from presto_tpu_torch.plan import nodes as port_nodes
from presto_tpu_torch.plan.optimizer import prune_columns as port_prune
from presto_tpu_torch.server import exchange_spi as port_spi
from presto_tpu_torch.server import pages_wire as port_wire
from presto_tpu_torch.server import scheduler as port_sched
from presto_tpu_torch.server.protocol import FragmentSpec as PortSpec
from presto_tpu_torch.sql import parse_statement as port_parse
from tpch_queries import QUERIES
from torch_parity import one_torch_thread  # noqa: F401

ROWS = 1000
CAPACITY = 1024


@pytest.fixture(scope="module")
def runners():
    return RefRunner(), LocalQueryRunner(device="cpu")


def _fragment_specs(runner, parse, prune, peel, gathers, plan_stage,
                    nodes, spec_cls, sql):
    """Every worker fragment of ``sql`` as the coordinator ships it:
    planned, pruned, the host root stage peeled, cut at the gathers and
    at each stage's partial aggregation."""
    plan = runner._plan_statement(parse(sql))
    root, _ = peel(prune(runner._bind_params(plan)))
    out = []
    remotes = [
        n for n in nodes.walk(gathers(root))
        if isinstance(n, nodes.RemoteSourceNode)
    ]
    for i, r in enumerate(remotes):
        stage = plan_stage(r.fragment_root, runner.catalogs)
        spec = spec_cls(
            task_id=f"q_c1_ab12cd.s.{i}.0",
            query_id="q_c1_ab12cd",
            fragment=stage.worker_fragment,
            partition_scan=stage.partition_scan,
            split_start=0,
            split_end=stage.partition_rows,
            split_batch_rows=4096,
            n_partitions=2,
            partition_keys=("k",),
            traceparent="00-" + "a" * 32 + "-" + "b" * 16 + "-01",
        )
        out.append(json.dumps(spec.to_json(), sort_keys=True))
    return out


@pytest.mark.parametrize("q", [1, 3, 18])
def test_fragment_spec_json_equals_the_reference(runners, q):
    ref_runner, port_runner = runners
    ref = _fragment_specs(
        ref_runner, ref_parse, ref_prune, ref_peel, ref_gathers,
        ref_sched.plan_stage, ref_nodes, RefSpec, QUERIES[q],
    )
    port = _fragment_specs(
        port_runner, port_parse, port_prune, port_peel, port_gathers,
        port_sched.plan_stage, port_nodes, PortSpec, QUERIES[q],
    )
    assert ref and port == ref
    # and the port decodes the reference's JSON back to an equal spec
    back = PortSpec.from_json(json.loads(ref[0]))
    assert json.dumps(back.to_json(), sort_keys=True) == ref[0]


def _page_values(seed: int):
    rng = np.random.default_rng(seed)
    words = ["apple", "fig", "kiwi", "date", "plum"]
    return {
        "b": [int(x) for x in rng.integers(-(2**40), 2**40, ROWS)],
        "i": [
            None if k % 7 == 0 else int(x)
            for k, x in enumerate(rng.integers(-1000, 1000, ROWS))
        ],
        "d": [float(x) for x in rng.normal(size=ROWS)],
        "r": [float(np.float32(x)) for x in rng.normal(size=ROWS)],
        "f": [bool(x) for x in rng.integers(0, 2, ROWS)],
        "s": [
            None if k % 5 == 0 else words[x]
            for k, x in enumerate(rng.integers(0, 5, ROWS))
        ],
        "dt": [int(x) for x in rng.integers(9000, 10000, ROWS)],
        "dec": [int(x) for x in rng.integers(0, 10**9, ROWS)],
        "a": [
            [int(y) for y in rng.integers(0, 9, int(m))]
            for m in rng.integers(0, 4, ROWS)
        ],
    }


_TYPES = {
    "b": "bigint", "i": "integer", "d": "double", "r": "real",
    "f": "boolean", "s": "varchar", "dt": "date",
    "dec": "decimal(12,2)", "a": "array(bigint)",
}


def _both_pages(seed: int):
    values = _page_values(seed)
    ref = ref_page.Page.from_pydict(
        values,
        {k: ref_types.parse_type(t) for k, t in _TYPES.items()},
        capacity=CAPACITY,
    )
    port = port_page.Page.from_pydict(
        values,
        {k: port_types.parse_type(t) for k, t in _TYPES.items()},
        capacity=CAPACITY,
        device="cpu",
    )
    return ref, port


def _frames(seed: int):
    ref, port = _both_pages(seed)
    rcols, rn = ref_wire.page_to_wire_columns(ref)
    pcols, pn = port_wire.page_to_wire_columns(port)
    return (
        ref_wire.serialize_page(rcols, rn),
        port_wire.serialize_page(pcols, pn),
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_page_frame_is_the_reference_bytes(seed):
    ref_frame, port_frame = _frames(seed)
    assert port_frame == ref_frame


def _payload_image(payload):
    """A payload as comparable plain data (names, kinds, arrays)."""
    out = {}
    for name, col in payload.items():
        kind = type(col).__name__
        if hasattr(col, "offsets"):
            parts = (col.offsets, col.values, col.valid)
        elif hasattr(col, "ids"):
            parts = (col.ids, tuple(col.values))
        elif hasattr(col, "valid"):
            parts = (col.data, col.valid, col.values)
        else:
            parts = (col,)
        out[name] = (kind, [
            None if p is None
            else (tuple(p) if isinstance(p, tuple) else np.asarray(p).tolist())
            for p in parts
        ])
    return out


def test_each_package_reads_the_others_frames():
    ref_frame, port_frame = _frames(2)
    rp, rs, rn = ref_wire.deserialize_page(port_frame)
    pp, ps, pn = port_wire.deserialize_page(ref_frame)
    assert rn == pn == ROWS
    assert {k: str(t) for k, t in rs.items()} == {
        k: str(t) for k, t in ps.items()
    }
    assert _payload_image(pp) == _payload_image(rp)
    # the frame the port deserialized re-serializes to the same bytes
    cols = port_wire.payload_to_wire_columns(pp, ps, pn)
    assert port_wire.serialize_page(cols, pn) == ref_frame


def test_encode_buffer_choices_equal_the_reference():
    rng = np.random.default_rng(3)
    bufs = [
        b"",
        b"x" * 100,  # under the compression floor: raw
        np.zeros(10_000, np.int64).tobytes(),  # compresses: zlib
        rng.integers(0, 2**63, 10_000).tobytes(),  # entropy: raw
    ]
    for raw in bufs:
        assert port_wire._encode_buffer(raw) == ref_wire._encode_buffer(raw)
        enc = port_wire._encode_buffer(raw)
        assert port_wire._decode_buffer(enc[0], enc[2]) == raw


def test_partition_slices_equal_the_reference():
    ref, port = _both_pages(4)
    rpay, rsch, rn = ref_streaming._page_to_payload(ref)
    ppay, psch, pn = port_streaming._page_to_payload(port)
    keys = ["s", "b"]
    rb = ref_streaming._bucket_of(rpay, keys, rn, 3)
    pb = port_streaming._bucket_of(ppay, keys, pn, 3)
    np.testing.assert_array_equal(pb, rb)
    ref_slices = list(ref_spi._serialize_partition_slices(rpay, rsch, rn, rb))
    port_slices = list(
        port_spi._serialize_partition_slices(ppay, psch, pn, pb)
    )
    assert port_slices == ref_slices
    assert len(port_slices) == 3


def test_wire_row_bytes_equal_the_reference():
    ref, port = _both_pages(5)
    assert port_spi._wire_row_bytes(port) == ref_spi._wire_row_bytes(ref)


@pytest.mark.parametrize(
    "total,n", [(0, 4), (10, 3), (59_997, 8), (7, 10), (1 << 20, 6)]
)
def test_assign_ranges_equal_the_reference(total, n):
    assert port_sched.assign_ranges(total, n) == ref_sched.assign_ranges(
        total, n
    )


@dataclasses.dataclass
class _Node:
    node_id: str
    state: str = "ACTIVE"
    slice_id: str = ""
    preemptible: bool = False


_TOPOLOGIES = {
    "one-slice": [_Node("a", slice_id="s1"), _Node("b", slice_id="s1")],
    "mixed": [
        _Node("a", slice_id="s1"), _Node("b", slice_id="s1"),
        _Node("c", slice_id="s2"),
    ],
    "unannounced": [_Node("a"), _Node("b")],
    "draining": [
        _Node("a", slice_id="s1"), _Node("b", "DRAINING", "s1"),
    ],
    "lone": [_Node("a", slice_id="s1"), _Node("b", slice_id="s2")],
    "preemptible": [
        _Node("a", preemptible=True), _Node("b"), _Node("c"),
    ],
    "too-wide": [_Node(str(i), slice_id="s") for i in range(65)],
}


@pytest.mark.parametrize("topology", sorted(_TOPOLOGIES))
@pytest.mark.parametrize("enabled", [False, True])
@pytest.mark.parametrize("nested", [False, True])
def test_transport_choice_equals_the_reference(topology, enabled, nested):
    workers = _TOPOLOGIES[topology]
    schemas_ref = ({"k": ref_types.BIGINT},) + (
        ({"a": ref_types.array(ref_types.BIGINT)},) if nested else ()
    )
    schemas_port = ({"k": port_types.BIGINT},) + (
        ({"a": port_types.array(port_types.BIGINT)},) if nested else ()
    )
    for fn in ("select_exchange_transport", "select_exchange_edges"):
        assert getattr(port_sched, fn)(
            workers, enabled, schemas=schemas_port
        ) == getattr(ref_sched, fn)(workers, enabled, schemas=schemas_ref)
    assert [w.node_id for w in port_sched.stable_workers(workers)] == [
        w.node_id for w in ref_sched.stable_workers(workers)
    ]


def _summary_pages(seed: int, empty: bool = False):
    rng = np.random.default_rng(seed)
    n = 0 if empty else 300
    values = {
        "k": [int(x) for x in rng.integers(-50, 50, n)],
        "w": [int(x) for x in rng.integers(0, 10**12, n)],
        "d": [
            float("nan") if k % 11 == 0 else float(x)
            for k, x in enumerate(rng.normal(size=n))
        ],
        "s": [
            None if k % 4 == 0 else f"v{x}"
            for k, x in enumerate(rng.integers(0, 30, n))
        ],
        "dt": [int(x) for x in rng.integers(9000, 9040, n)],
    }
    types = {"k": "integer", "w": "bigint", "d": "double", "s": "varchar",
             "dt": "date"}
    ref = ref_page.Page.from_pydict(
        values, {c: ref_types.parse_type(t) for c, t in types.items()},
        capacity=512,
    )
    port = port_page.Page.from_pydict(
        values, {c: port_types.parse_type(t) for c, t in types.items()},
        capacity=512, device="cpu",
    )
    return ref, port, types


@pytest.mark.parametrize("ndv", [8, 64])
def test_filter_summaries_equal_the_reference(ndv):
    keys = ["k", "w", "d", "s", "dt"]
    summaries = []
    for seed, empty in ((6, False), (7, False), (8, True)):
        ref, port, types = _summary_pages(seed, empty)
        rs = ref_df.summarize_page(ref, keys, ndv_limit=ndv)
        ps = port_df.summarize_page(port, keys, ndv_limit=ndv)
        assert ps.to_json() == rs.to_json()
        summaries.append((rs, ps))
    rm, pm = summaries[0]
    for rs, ps in summaries[1:]:
        rm, pm = rm.merge(rs, ndv), pm.merge(ps, ndv)
    assert pm.to_json() == rm.to_json()
    back = port_df.FilterSummary.from_json(json.loads(json.dumps(rm.to_json())))
    assert back.to_json() == rm.to_json()
    ref_cols = [(c, ref_types.parse_type(t)) for c, t in types.items()]
    port_cols = [(c, port_types.parse_type(t)) for c, t in types.items()]
    assert port_df.applicable_count(pm, port_cols) == ref_df.applicable_count(
        rm, ref_cols
    )
    assert repr(port_df.to_predicate(pm, port_cols)) == repr(
        ref_df.to_predicate(rm, ref_cols)
    )
    assert repr(port_df.to_constraint(pm, port_cols)) == repr(
        ref_df.to_constraint(rm, ref_cols)
    )
    base = (("dt", (9001,)),)
    assert repr(
        port_df.merge_constraints(base, port_df.to_constraint(pm, port_cols))
    ) == repr(
        ref_df.merge_constraints(base, ref_df.to_constraint(rm, ref_cols))
    )
