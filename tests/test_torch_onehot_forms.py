"""K1's two call forms against the reference, on the CPU.

The one-hot reduction (``presto_tpu_torch/ops/aggregation.py``) takes
a GROUP BY's K requests for one lane or for a micro-batch's L lanes in
one call. On a card that call is one launch of the kernel per 64
requests (``K_MAX``): the direct form when each lane fits one block,
the large form otherwise (``onehot_blocks_per_lane``). On the CPU the
wrappers take their plain versions, so these tests hold the operator's
lane and many-request paths against the JAX package's one-hot GROUP BY
(``presto_tpu/ops/aggregation.py::_onehot_aggregate``), run once per
lane on the same rows, and check the grid the card would take.
``tests/test_torch_cuda.py`` holds the kernel's forms against the plain
versions on the card.
"""

from __future__ import annotations

import dataclasses
import itertools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu import expr as RE
from presto_tpu import page as RP
from presto_tpu import types as RT
from presto_tpu.ops import aggregation as RA
from presto_tpu_torch import convert
from presto_tpu_torch import expr as PE
from presto_tpu_torch import page as PP
from presto_tpu_torch import types as PT
from presto_tpu_torch.ops import aggregation as PA
from torch_parity import assert_columns_equal, both_pages, jax_live_columns
from torch_parity import one_torch_thread  # noqa: F401

#: rows of one lane's page
CAP = 256

#: the H100's large-form grid: 4 blocks on each of its 132 SMs
H100_GRID = 4 * 132


def _columns(seed: int):
    rng = np.random.default_rng(seed)
    return {
        "flag": (rng.integers(0, 3, CAP).astype(np.int32), None, "varchar",
                 np.asarray(["A", "N", "R"], object)),
        "status": (rng.integers(0, 2, CAP).astype(np.int32), None, "varchar",
                   np.asarray(["F", "O"], object)),
        "mode": (rng.integers(0, 4, CAP).astype(np.int32),
                 rng.random(CAP) < 0.8, "varchar",
                 np.asarray(["AIR", "MAIL", "RAIL", "SHIP"], object)),
        "i": (rng.integers(-10**12, 10**12, CAP).astype(np.int64),
              rng.random(CAP) < 0.8, "bigint", None),
        "n": (rng.integers(-50, 50, CAP).astype(np.int32), None, "integer",
              None),
        "d": (rng.integers(-10**7, 10**7, CAP).astype(np.int64),
              rng.random(CAP) < 0.9, "decimal(12,2)", None),
        "q": (rng.integers(100, 5000, CAP).astype(np.int64), None,
              "decimal(12,2)", None),
        "f": (rng.standard_normal(CAP) * 1e3, rng.random(CAP) < 0.85,
              "double", None),
    }


def _types():
    return {name: col[2] for name, col in _columns(0).items()}


def _ref(name):
    return RE.ColumnRef(name, RT.parse_type(_types()[name]))


def _port(name):
    return PE.ColumnRef(name, PT.parse_type(_types()[name]))


#: aggregates by the requests each adds to the call beyond the live-row
#: count (a nullable argument adds its own count)
POOL = [
    (("sum", "i"), 2), (("avg", "f"), 2), (("min", "q"), 1),
    (("var_pop", "d"), 3), (("max", "f"), 2), (("sum", "q"), 1),
    (("min", "d"), 2), (("avg", "q"), 1), (("max", "n"), 1),
    (("sum", "f"), 2), (("count", "i"), 1), (("stddev_samp", "f"), 3),
]


def _aggs_for(k: int):
    """Aggregates whose one-hot call makes exactly ``k`` requests:
    count(*) (the live-row count alone), then POOL's aggregates in turn,
    each taken while it still fits."""
    aggs, got = [("count_star", None)], 1
    for spec, adds in itertools.cycle(POOL):
        if got == k:
            return aggs
        if got + adds <= k:
            aggs.append(spec)
            got += adds


def _calls(col, A, aggs):
    return [A.AggCall(func, None if arg is None else col(arg), f"a{i}")
            for i, (func, arg) in enumerate(aggs)]


def _lane_masks(lanes: int, seed: int) -> np.ndarray:
    """Each lane's live rows: its own fraction of the page (as a
    micro-batch's members filter with their own literals); lane 1 keeps
    no row."""
    rng = np.random.default_rng(seed)
    keep = rng.random(lanes)
    masks = rng.random((lanes, CAP)) < keep[:, None]
    if lanes > 1:
        masks[1] = False
    return masks


def _port_lane_page(out: PP.Page, lane: int, nseg: int) -> PP.Page:
    """Lane ``lane``'s rows of a lane-blocked aggregation output."""
    sl = slice(lane * nseg, (lane + 1) * nseg)
    live = out.live[sl]
    return PP.Page(
        blocks=tuple(
            dataclasses.replace(
                b, data=b.data[sl],
                valid=None if b.valid is None else b.valid[sl])
            for b in out.blocks
        ),
        num_valid=torch.sum(live).to(torch.int32),
        names=out.names,
        live=live,
    )


def _group_by_lanes(keys, aggs, lanes: int, seed: int, monkeypatch):
    """One lane-blocked GROUP BY through the port (``lanes`` > 1: the
    micro-batch's ``hash_aggregate(..., lanes=)``; 1: the scalar path)
    against the reference's ``_onehot_aggregate`` once per lane, each
    lane's live rows its own. Returns the port's one-hot calls as
    (wrapper, K, nseg, lanes)."""
    cols = _columns(seed)
    ref_page, port_page = both_pages(cols, CAP)
    masks = _lane_masks(lanes, seed)

    calls = []
    real_many, real_lanes = PA.onehot_reduce_many, PA.onehot_reduce_lanes

    def many(gid, requests, nseg):
        calls.append(("many", len(requests), nseg, 1))
        return real_many(gid, requests, nseg)

    def lane_call(gid, requests, nseg, n):
        calls.append(("lanes", len(requests), nseg, n))
        return real_lanes(gid, requests, nseg, n)

    monkeypatch.setattr(PA, "onehot_reduce_many", many)
    monkeypatch.setattr(PA, "onehot_reduce_lanes", lane_call)
    ref_onehot = []
    real_ref = RA._onehot_aggregate

    def ref_spy(*args, **kwargs):
        ref_onehot.append(args[4])
        return real_ref(*args, **kwargs)

    monkeypatch.setattr(RA, "_onehot_aggregate", ref_spy)

    if lanes == 1:
        live = torch.from_numpy(masks[0])
        port_in = PP.Page(port_page.blocks, torch.sum(live).to(torch.int32),
                          port_page.names, live)
    else:
        tiled = PP.tile_lanes(port_page, lanes)
        live = torch.from_numpy(masks.reshape(-1))
        port_in = PP.Page(tiled.blocks, torch.sum(live).to(torch.int32),
                          tiled.names, live)
    port_out, ovf = PA.hash_aggregate(
        port_in, [(k, _port(k)) for k in keys], _calls(_port, PA, aggs),
        CAP, lanes=lanes,
    )
    assert not bool(ovf)
    for lane in range(lanes):
        m = masks[lane]
        ref_in = RP.Page(ref_page.blocks, jnp.asarray(int(m.sum()), jnp.int32),
                         ref_page.names, jnp.asarray(m))
        ref_out, _ = RA.hash_aggregate(
            ref_in, [(k, _ref(k)) for k in keys], _calls(_ref, RA, aggs), CAP,
        )
        nseg = ref_onehot[-1]
        got = port_out if lanes == 1 else _port_lane_page(port_out, lane, nseg)
        assert int(got.num_valid) == int(ref_out.num_valid), lane
        assert_columns_equal(
            jax_live_columns(ref_out), convert.page_to_numpy(got)
        )
    assert len(ref_onehot) == lanes
    return calls


@pytest.mark.parametrize(
    "lanes,keys,nseg",
    [(4, ["flag", "status"], 6), (50, ["flag", "status"], 6),
     (60, ["mode"], 5)],
    ids=["4x6", "50x6", "60x5"],
)
def test_lane_group_by_equals_reference_per_lane(lanes, keys, nseg,
                                                 monkeypatch):
    """L lanes x nseg segments under 256 (4 x 6) and over it (50 x 6 and
    60 x 5 = 300, which the old segment-id fold split into two
    launches): one lane call, each lane equal to the reference's GROUP BY
    over that lane's rows, and one launch on a card."""
    aggs = _aggs_for(19)
    calls = _group_by_lanes(keys, aggs, lanes, lanes, monkeypatch)
    assert calls == [("lanes", 19, nseg, lanes)] and 19 <= PA.K_MAX


@pytest.mark.parametrize("lanes", [1, 8])
@pytest.mark.parametrize("k", [1, 16, 19, 40])
def test_k_requests_are_one_call_equal_to_reference(k, lanes, monkeypatch):
    """A GROUP BY of K requests (1, 16, 19 as an ICI merge's final, 40)
    is one call, equal to the reference, and one launch on a card
    (requests beyond 16 took a second launch before)."""
    calls = _group_by_lanes(["flag", "status"], _aggs_for(k), lanes,
                            100 + k, monkeypatch)
    wrapper = "many" if lanes == 1 else "lanes"
    assert calls == [(wrapper, k, 6, lanes)] and k <= PA.K_MAX


@pytest.mark.parametrize(
    "rows,lanes,blocks",
    [
        (0, 1, 0),  # no row: the direct form writes identities
        (100, 1, 0),  # an ICI merge's final
        (4096, 64, 0),  # the direct form's largest lane
        (4097, 1, 2),  # the large form: 4,096 rows a block or more
        (1 << 23, 1, 528),  # Q1 at SF1: the whole grid
        (1 << 23, 8, 66),  # V3's batch: the grid over 8 lanes
        (1 << 20, 64, 8),
        (10_000, 1000, 1),  # more lanes than the grid: one each
    ],
)
def test_blocks_per_lane(rows, lanes, blocks):
    assert PA.onehot_blocks_per_lane(rows, lanes, H100_GRID) == blocks


@pytest.mark.parametrize(
    "python_name,cuda_name",
    [("K_MAX", "kMaxRequests"), ("_DIRECT_MAX_ROWS", "kDirectMaxRows")],
)
def test_wrapper_limits_match_the_kernel_source(python_name, cuda_name):
    """The wrapper's limits are the kernel's: a launch past either is
    refused by the kernel's entry point."""
    src = (Path(PA.__file__).parents[1] / "csrc" / "onehot_reduce.cu")
    found = re.search(rf"constexpr int {cuda_name} = (\d+);",
                      src.read_text())
    assert found, f"{cuda_name} not in {src.name}"
    assert getattr(PA, python_name) == int(found.group(1))


def test_lanes_wrapper_checks_its_arguments():
    g = torch.zeros(8, dtype=torch.int32)
    x = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="no requests"):
        PA.onehot_reduce_lanes(g, [], 4, 2)
    with pytest.raises(ValueError, match="lanes"):
        PA.onehot_reduce_lanes(g, [("sum", x, None)], 4, 3)
    with pytest.raises(ValueError):
        PA.onehot_reduce_lanes(g, [("sum", x[:4], None)], 4, 2)
    with pytest.raises(ValueError):
        PA.onehot_reduce_lanes(g, [("sum", x, None)], 300, 2)
    # no silent CPU fallback: a device without the kernel raises
    with pytest.raises(ValueError, match="no kernel"):
        PA.onehot_reduce_lanes(g.to("meta"), [("sum", x.to("meta"), None)],
                               4, 2)
