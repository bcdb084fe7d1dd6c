"""The port's copy of the tpch connector generates exactly the
reference's data (its numpy-only ``_uniform`` against the reference's
native-or-numpy one) and reports the same metadata."""

from __future__ import annotations

import numpy as np
import pytest

from presto_tpu.connectors import tpch as ref_tpch
from presto_tpu.connectors.spi import TableHandle as RefHandle
from presto_tpu_torch.connectors import create_connector
from presto_tpu_torch.connectors import tpch as port_tpch
from presto_tpu_torch.connectors.spi import TableHandle
from torch_parity import one_torch_thread  # noqa: F401

TABLES = ["lineitem", "orders", "customer", "part", "partsupp", "supplier",
          "nation", "region"]


def _payload_equal(name, ref, port):
    if isinstance(ref, ref_tpch.DictColumn):
        assert isinstance(port, port_tpch.DictColumn), name
        assert port.ids.dtype == ref.ids.dtype, name
        np.testing.assert_array_equal(port.ids, ref.ids, err_msg=name)
        assert list(port.values) == list(ref.values), name
    else:
        port, ref = np.asarray(port), np.asarray(ref)
        assert port.dtype == ref.dtype, name
        np.testing.assert_array_equal(port, ref, err_msg=name)


@pytest.mark.parametrize("table", TABLES)
def test_tiny_columns_match_reference(table):
    ref_conn = ref_tpch.TpchConnector()
    port_conn = create_connector("tpch")
    cols = list(port_tpch.TABLE_SCHEMAS[table])
    assert cols == list(ref_tpch.TABLE_SCHEMAS[table])
    ref_split = ref_conn.get_splits(RefHandle("tpch", "tiny", table))
    port_split = port_conn.get_splits(TableHandle("tpch", "tiny", table))
    ref_all = [s for s in ref_split.next_batch(1 << 10)]
    port_all = [s for s in port_split.next_batch(1 << 10)]
    assert [(s.row_start, s.row_end) for s in port_all] == [
        (s.row_start, s.row_end) for s in ref_all
    ]
    for rs, ps in zip(ref_all, port_all):
        ref = ref_conn.create_page_source(rs, cols)
        port = port_conn.create_page_source(ps, cols)
        for c in cols:
            _payload_equal(f"{table}.{c}", ref[c], port[c])


@pytest.mark.parametrize("schema", ["tiny", "sf1"])
def test_stats_match_reference(schema):
    ref_md = ref_tpch.TpchConnector().metadata()
    port_md = create_connector("tpch").metadata()
    for table in TABLES:
        r = ref_md.get_table_stats(RefHandle("tpch", schema, table))
        p = port_md.get_table_stats(TableHandle("tpch", schema, table))
        assert p.row_count == r.row_count
        assert p.primary_key == r.primary_key
        assert set(p.columns) == set(r.columns)


def test_uniform_matches_reference_on_large_ranges():
    # large affine index ranges are where the reference may take its
    # native generator; the port's numpy path must agree bit for bit
    idx = np.arange(100_000, 400_000, dtype=np.int64)
    np.testing.assert_array_equal(
        port_tpch._uniform(703, idx, 1, 50), ref_tpch._uniform(703, idx, 1, 50)
    )
