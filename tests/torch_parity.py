"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

One input, made from a seed with numpy, goes through the JAX reference
(``presto_tpu``) and through the port (``presto_tpu_torch``) on the CPU;
these helpers build both packages' pages from the same numpy column
tuples (``presto_tpu_torch.convert``) and read results back the same way.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from presto_tpu import page as ref_page
from presto_tpu import types as ref_types
from presto_tpu_torch import convert

#: DOUBLE results are compared within this relative tolerance: both
#: engines sum float64 in a different order (XLA's reduction tree vs
#: torch's), so the last bits may differ
DOUBLE_RTOL = 1e-9


def jax_page(columns, num_valid: int) -> ref_page.Page:
    """The reference's Page from the same column tuples the port's
    ``convert.page_from_numpy`` takes."""
    blocks = []
    for data, valid, type_name, dict_values in columns.values():
        t = ref_types.parse_type(type_name)
        dictionary = (
            None
            if dict_values is None
            else ref_page.Dictionary(np.asarray(dict_values, dtype=object))
        )
        blocks.append(ref_page.Block.from_numpy(data, t, valid, dictionary))
    return ref_page.Page(
        blocks=tuple(blocks),
        num_valid=jnp.asarray(num_valid, dtype=jnp.int32),
        names=tuple(columns),
    )


def both_pages(columns, num_valid: int):
    return (
        jax_page(columns, num_valid),
        convert.page_from_numpy(columns, num_valid),
    )


def jax_live_columns(page: ref_page.Page):
    """The reference page's live rows, in order, as column tuples."""
    page = ref_page.compact_page(page)
    n = int(page.num_valid)
    out = {}
    for name, blk in zip(page.names, page.blocks):
        out[name] = (
            np.asarray(blk.data)[:n],
            None if blk.valid is None else np.asarray(blk.valid)[:n],
            str(blk.dtype),
            None if blk.dictionary is None else blk.dictionary.values,
        )
    return out


def assert_columns_equal(ref_cols, port_cols, rtol: float = DOUBLE_RTOL):
    """Same names, types, dictionaries and validity; values exact except
    floating columns (within ``rtol``). Values under a NULL are not
    compared."""
    assert list(ref_cols) == list(port_cols)
    for name in ref_cols:
        rd, rv, rt, rdict = ref_cols[name]
        pd, pv, pt, pdict = port_cols[name]
        assert rt == pt, (name, rt, pt)
        assert rd.shape == pd.shape, (name, rd.shape, pd.shape)
        r_valid = np.ones(len(rd), bool) if rv is None else np.asarray(rv)
        p_valid = np.ones(len(pd), bool) if pv is None else np.asarray(pv)
        np.testing.assert_array_equal(r_valid, p_valid, err_msg=name)
        if rdict is not None or pdict is not None:
            assert list(rdict) == list(pdict), name
        rd, pd = rd[r_valid], pd[p_valid]
        if np.issubdtype(rd.dtype, np.floating):
            np.testing.assert_allclose(
                pd, rd, rtol=rtol, atol=0, equal_nan=True, err_msg=name
            )
        else:
            np.testing.assert_array_equal(pd, rd, err_msg=name)

