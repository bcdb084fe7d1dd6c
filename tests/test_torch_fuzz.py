"""Differential fuzzing of the port against the JAX reference on the CPU.

The reference's query fuzzer (``presto_tpu/fuzz.py::generate_query``)
draws each seed's SQL over tpch.tiny and ``session_draw`` its fragment
budget and dynamic filtering; both runners execute it under that
session, and under the same session with ``max_device_rows`` 8,192,
where lineitem and orders stream with host spill. Rows are compared
with the reference's ``verifier.diff_results`` at rel 1e-9.

The seeds are pinned: a contiguous range under the default draw, plus
the seeds that found the broadcast-column fault (a one-row result
holding a stride-0 block: 1130, and under streaming 24, 26, 58, 70,
125, 157, 158, 263, 264, 292, 376 and 432), and the seeds whose queries
unnest an array (an ``UnnestNode``: 17, 34, 35, 81 and 94, and 209
streamed, which expands a streamed lineitem scan under a TopN). The seed
count is kept small because the reference's XLA compiles dominate the
run time."""

from __future__ import annotations

import pytest

from presto_tpu.exec.local_runner import LocalQueryRunner as RefRunner
from presto_tpu.fuzz import generate_query, session_draw
from presto_tpu.session import Session as RefSession
from presto_tpu.sql import parse_statement
from presto_tpu.verifier import diff_results
from presto_tpu_torch.exec.local_runner import LocalQueryRunner
from presto_tpu_torch.session import Session
from torch_parity import one_torch_thread  # noqa: F401

REL = 1e-9
STREAM_ROWS = 8_192

#: seeds whose query unnests an array
UNNEST_SEEDS = [17, 34, 35, 81, 94]
DEFAULT_SEEDS = list(range(12)) + UNNEST_SEEDS + [1130]
STREAMED_SEEDS = [24, 26, 58, 70, 125, 157, 158, 209, 263, 264, 292, 376,
                  432]


@pytest.fixture(scope="module")
def runners():
    """(reference, port) runners, one pair per distinct session."""
    made = {}

    def get(props):
        key = tuple(sorted(props.items()))
        if key not in made:
            made[key] = (
                RefRunner(session=RefSession(properties=dict(props))),
                LocalQueryRunner(device="cpu", session=Session(properties=dict(props))),
            )
        return made[key]

    return get


def _check(runners, seed, props):
    sql = generate_query(seed)
    ref, port = runners(props)
    want = ref.execute(sql).rows()
    if seed in UNNEST_SEEDS or seed == 209:
        assert "unnest" in sql.lower()
    got = port.execute(sql).rows()
    ordered = bool(parse_statement(sql).order_by)
    diff = diff_results(got, want, ordered, REL)
    assert diff is None, f"seed {seed} ({props}): {diff}\n{sql}"


@pytest.mark.parametrize("seed", DEFAULT_SEEDS)
def test_seed_matches_reference(runners, seed):
    _check(runners, seed, dict(session_draw(seed)))


@pytest.mark.parametrize("seed", STREAMED_SEEDS)
def test_streamed_seed_matches_reference(runners, seed):
    _check(runners, seed,
           {**session_draw(seed), "max_device_rows": STREAM_ROWS})
