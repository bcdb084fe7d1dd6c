"""What the generators share: one random stream per column, keyed by the
seed and the column's name, and the column types they return."""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Sequence, Tuple

import torch


@dataclasses.dataclass
class Varchar:
    """A varchar column: int32 ids into ``values``, which are sorted, so
    the order of the ids is the order of the strings."""

    ids: torch.Tensor
    values: Tuple[str, ...]


#: a generated table: column name -> tensor (int32 keys and dates as
#: epoch days, int64 decimals as unscaled integers) or Varchar
Table = Dict[str, object]


def stream(seed: int, name: str, device) -> torch.Generator:
    """A generator on ``device`` for the column or draw ``name``: its
    numbers depend on the seed and the name alone, not on what else was
    drawn before it."""
    digest = hashlib.blake2b(
        f"{int(seed)}:{name}".encode(), digest_size=8
    ).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(digest, "little") >> 1)
    return g


def uniform(seed: int, name: str, lo: int, hi: int, n: int, device):
    """``n`` integers uniform in [lo, hi], int64."""
    return torch.randint(
        lo, hi + 1, (n,), generator=stream(seed, name, device),
        device=device, dtype=torch.int64,
    )


def shuffled(seed: int, name: str, values: torch.Tensor) -> torch.Tensor:
    """``values`` in an order drawn from the seed: every seed gets the
    same multiset, so every seed gets the same sizes."""
    g = stream(seed, name, values.device)
    return values[torch.randperm(len(values), generator=g,
                                 device=values.device)]


def sorted_values(values: Sequence[str], what: str) -> Tuple[str, ...]:
    out = tuple(values)
    if list(out) != sorted(out) or len(set(out)) != len(out):
        raise ValueError(f"{what}: the dictionary must be sorted and unique")
    return out


def varchar(ids: torch.Tensor, values: Sequence[str]) -> Varchar:
    return Varchar(ids=ids.to(torch.int32), values=tuple(values))


def check_rows(config: dict, table: str, n: int) -> None:
    want = config["tables"][table]["rows"]
    if n != want:
        raise ValueError(
            f"{config['name']}.{table}: generated {n} rows, the "
            f"configuration states {want}"
        )


def rows_of(column) -> int:
    return len(column.ids) if isinstance(column, Varchar) else len(column)
