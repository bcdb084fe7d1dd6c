"""Equi-join and cross join: inner / left outer / full outer / semi /
anti (right outer is planned as left outer with the sides swapped).

The PyTorch counterpart of ``presto_tpu/ops/join.py``, with its design:
no pointer-chasing hash table. The build side is sorted by key once,
and every probe row finds its match range with two vectorized
``searchsorted`` binary searches. Duplicate build keys become [lo, hi)
ranges; the output expansion is the prefix-sum + inverse-searchsorted
trick, all static-shape: the planner supplies ``out_capacity`` and the
operator reports overflow (the runner re-runs at a bigger bucket).

Keys are single int64 columns; two 32-bit key columns pack bijectively
via ``pack_keys``. NULL keys never match; anti join keeps unmatched
probe rows (NOT EXISTS semantics). A join key of exactly int64-max is
unsupported (the sentinel), as in the reference. Long-decimal keys are
not ported yet: they raise. The match count and the overflow flag stay
0-d device tensors: no operator here makes the host wait for the card.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch.ops.common import orderable_i64
from presto_tpu_torch.page import Block, Page, compact_page

_I64_MAX = torch.iinfo(torch.int64).max


def pack_keys(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Bijectively pack two int32-representable key columns into int64."""
    return (a.to(torch.int64) << 32) | (b.to(torch.int64) & 0xFFFFFFFF)


def _key_of(
    page: Page, key_cols: Sequence[str]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int64 key, ok-mask) for live rows with non-null key columns."""
    ok = page.row_mask()
    datas = []
    widths = []
    for name in key_cols:
        blk = page.block(name)
        if blk.dtype.is_long_decimal:
            raise NotImplementedError(
                f"long-decimal join key {name}: later slice of the port"
            )
        datas.append(orderable_i64(blk.data, blk.dtype))
        widths.append(blk.dtype.np_dtype.itemsize)
        if blk.valid is not None:
            ok = ok & blk.valid
    if len(datas) == 1:
        key = datas[0]
    elif len(datas) == 2:
        # the pack is bijective only for 32-bit key columns; wider values
        # would wrap and silently collide
        if any(w > 4 for w in widths):
            raise NotImplementedError(
                "two-column join keys must be 32-bit columns "
                f"(got widths {widths}); planner must narrow first"
            )
        key = pack_keys(datas[0], datas[1])
    else:
        raise NotImplementedError(
            ">2 join key columns (pack wider composites in the planner)"
        )
    return key, ok


def _mask_out(page: Page, keep: torch.Tensor) -> Page:
    """Select rows of ``page`` lazily: keep them in place under a live
    mask (the Page's masked form) instead of a compaction gather."""
    return dataclasses.replace(
        page, live=keep, num_valid=torch.sum(keep).to(torch.int32)
    )


def _no_overflow(page: Page) -> torch.Tensor:
    return torch.zeros((), dtype=torch.bool, device=page.device)


def hash_join(
    probe: Page,
    build: Page,
    probe_keys: Sequence[str],
    build_keys: Sequence[str],
    join_type: str = "inner",
    build_payload: Optional[Sequence[str]] = None,
    build_unique: bool = False,
    out_capacity: Optional[int] = None,
    payload_rename: Optional[dict] = None,
) -> Tuple[Page, torch.Tensor]:
    """Join ``probe`` with ``build`` on equality of packed keys.

    Returns (result, overflow). Result columns = all probe columns plus
    ``build_payload`` columns (optionally renamed via ``payload_rename``).
    join_type: inner | left | full | semi | anti.

    FULL OUTER runs as left outer plus an appended section of unmatched
    build rows (probe columns NULL), carried by the live mask."""
    build_payload = list(build_payload or [])
    payload_rename = payload_rename or {}

    for pc, bc in zip(probe_keys, build_keys):
        pb, bb = probe.block(pc), build.block(bc)
        if pb.dtype.is_string or bb.dtype.is_string:
            # ids are only comparable within ONE dictionary
            if pb.dictionary != bb.dictionary:
                raise NotImplementedError(
                    f"string join key {pc}={bc} across different "
                    "dictionaries: planner must re-encode first"
                )

    pk, p_ok = _key_of(probe, probe_keys)
    bk, b_ok = _key_of(build, build_keys)

    # sort build by key; unmatchable rows carry the sentinel and sort last
    b_sort_key = torch.where(b_ok, bk, _I64_MAX)
    bk_s, b_order = torch.sort(b_sort_key, stable=True)
    nb = torch.sum(b_ok)

    pk_eff = torch.where(p_ok, pk, _I64_MAX)
    lo = torch.minimum(torch.searchsorted(bk_s, pk_eff), nb)
    hi = torch.minimum(torch.searchsorted(bk_s, pk_eff, right=True), nb)
    m = torch.where(p_ok, hi - lo, 0)  # matches per probe row

    if join_type == "semi":
        return _mask_out(probe, m > 0), _no_overflow(probe)
    if join_type == "anti":
        keep = (m == 0) & probe.row_mask()
        return _mask_out(probe, keep), _no_overflow(probe)

    outer = join_type in ("left", "full")
    if build_unique:
        # PK side: m in {0,1}; output row i <-> probe row i, so the
        # probe columns pass through ungathered
        matched = m > 0
        b_idx = b_order[torch.clamp(lo, 0, build.capacity - 1)]
        out = _join_output(
            probe, build, None, b_idx, matched, build_payload,
            payload_rename, left_outer=outer,
        )
        if join_type == "inner":
            out = _mask_out(out, matched & probe.row_mask())
            return out, _no_overflow(probe)
        # left/full outer keep every probe row: positional layout, so
        # the probe's own liveness (mask or prefix) carries over
        out = dataclasses.replace(out, live=probe.live)
        if join_type == "full":
            out = _append_unmatched_build(
                out, probe, build, pk_eff, p_ok, bk, b_ok,
                build_payload, payload_rename,
            )
        return out, _no_overflow(probe)

    # general duplicate-capable expansion
    if out_capacity is None:
        raise ValueError("non-unique inner/left join requires out_capacity")
    m_eff = torch.clamp(m, min=1) if outer else m
    m_eff = torch.where(probe.row_mask(), m_eff, 0)
    p_idx, offset, out_count = _expand(m_eff, out_capacity)
    overflow = out_count > out_capacity
    row_m = m[p_idx]
    matched = row_m > 0
    b_pos = lo[p_idx] + torch.minimum(offset, torch.clamp(row_m - 1, min=0))
    b_idx = b_order[torch.clamp(b_pos, 0, build.capacity - 1)]
    out = _join_output(
        probe, build, p_idx, b_idx, matched, build_payload, payload_rename,
        left_outer=outer,
    )
    out = dataclasses.replace(
        out,
        num_valid=torch.clamp(out_count, max=out_capacity).to(torch.int32),
    )
    if join_type == "full":
        out = _append_unmatched_build(
            out, probe, build, pk_eff, p_ok, bk, b_ok,
            build_payload, payload_rename,
        )
    return out, overflow


def cross_join(
    left: Page, right: Page, out_capacity: int
) -> Tuple[Page, torch.Tensor]:
    """General nested-loop cross product under the capacity-bucket
    protocol: the duplicate-key join's expansion, with every live left
    row matching every live right row. Returns (result, overflow)."""
    right_c = compact_page(right)  # offsets index the live prefix
    nr = right_c.num_valid.to(torch.int64)
    m_eff = torch.where(left.row_mask(), nr, 0)
    p_idx, offset, out_count = _expand(m_eff, out_capacity)
    overflow = out_count > out_capacity
    b_idx = torch.clamp(offset, 0, right_c.capacity - 1)

    blocks = [_gather(blk, p_idx) for blk in left.blocks]
    blocks += [_gather(blk, b_idx) for blk in right_c.blocks]
    return (
        Page(
            blocks=tuple(blocks),
            num_valid=torch.clamp(out_count, max=out_capacity).to(
                torch.int32
            ),
            names=tuple(left.names) + tuple(right_c.names),
        ),
        overflow,
    )


def _expand(
    counts: torch.Tensor, out_capacity: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The static-shape layout of a fan-out where input row i yields
    ``counts[i]`` output rows: output row j is copy ``offset[j]`` of
    input row ``p_idx[j]`` (prefix sum + inverse searchsorted). Returns
    (p_idx, offset, out_count); rows past ``out_count`` are padding."""
    total = torch.cumsum(counts, dim=0)
    j = torch.arange(out_capacity, dtype=torch.int64, device=counts.device)
    p_idx = torch.clamp(
        torch.searchsorted(total, j, right=True), max=counts.shape[0] - 1
    )
    prev = torch.where(p_idx > 0, total[torch.clamp(p_idx - 1, min=0)], 0)
    return p_idx, j - prev, total[-1]


def _gather(blk: Block, idx: torch.Tensor) -> Block:
    return dataclasses.replace(
        blk,
        data=blk.data[idx],
        valid=None if blk.valid is None else blk.valid[idx],
    )


def _append_unmatched_build(
    out: Page,
    probe: Page,
    build: Page,
    pk_eff: torch.Tensor,
    p_ok: torch.Tensor,
    bk: torch.Tensor,
    b_ok: torch.Tensor,
    build_payload: Sequence[str],
    payload_rename: dict,
) -> Page:
    """FULL OUTER's second section: build rows no probe key matched,
    appended after the left-outer section with NULL probe columns. The
    result is a masked-form Page (section 1's liveness concatenated with
    the unmatched-build mask): no gathers."""
    dev = out.device
    # membership of each build key among the live probe keys, by binary
    # search in the sorted probe keys; matches beyond the live count are
    # sentinel slots, not real keys
    pk_sorted = torch.sort(torch.where(p_ok, pk_eff, _I64_MAX)).values
    n_live = torch.sum(p_ok)
    lo = torch.minimum(torch.searchsorted(pk_sorted, bk), n_live)
    hi = torch.minimum(torch.searchsorted(pk_sorted, bk, right=True), n_live)
    keep_b = build.row_mask() & ~(b_ok & (hi > lo))

    source = {payload_rename.get(c, c): c for c in build_payload}
    cap_b = build.capacity
    blocks = []
    for name, blk in zip(out.names, out.blocks):
        if name in source:
            b_blk = build.block(source[name])
            tail_data = b_blk.data
            tail_valid = (
                torch.ones((cap_b,), dtype=torch.bool, device=dev)
                if b_blk.valid is None
                else b_blk.valid
            )
        else:
            # probe column: NULL in the appended section
            tail_data = torch.zeros(
                (cap_b,), dtype=blk.data.dtype, device=dev
            )
            tail_valid = torch.zeros((cap_b,), dtype=torch.bool, device=dev)
        head_valid = (
            torch.ones((out.capacity,), dtype=torch.bool, device=dev)
            if blk.valid is None
            else blk.valid
        )
        blocks.append(
            dataclasses.replace(
                blk,
                data=torch.cat([blk.data, tail_data]),
                valid=torch.cat([head_valid, tail_valid]),
            )
        )
    return Page(
        blocks=tuple(blocks),
        num_valid=(out.num_valid + torch.sum(keep_b)).to(torch.int32),
        names=out.names,
        live=torch.cat([out.row_mask(), keep_b]),
    )


def _join_output(
    probe: Page,
    build: Page,
    p_idx: Optional[torch.Tensor],
    b_idx: torch.Tensor,
    matched: torch.Tensor,
    build_payload: Sequence[str],
    payload_rename: dict,
    left_outer: bool,
) -> Page:
    """All probe columns gathered at ``p_idx`` (None: row i is probe row
    i, no gather) and the build payload gathered at ``b_idx``; in a left
    outer join an unmatched row's payload is NULL."""
    for name in list(probe.names) + list(build_payload):
        src = probe if name in probe.names else build
        if src.block(name).dtype.is_nested:
            raise NotImplementedError(
                f"nested column {name}: later slice of the port"
            )
    names: List[str] = list(probe.names)
    if p_idx is None:
        blocks: List[Block] = list(probe.blocks)
    else:
        blocks = [_gather(blk, p_idx) for blk in probe.blocks]
    for name in build_payload:
        blk = _gather(build.block(name), b_idx)
        if left_outer:
            blk = dataclasses.replace(
                blk,
                valid=matched if blk.valid is None else (blk.valid & matched),
            )
        blocks.append(blk)
        names.append(payload_rename.get(name, name))
    return Page(
        blocks=tuple(blocks), num_valid=probe.num_valid, names=tuple(names)
    )
