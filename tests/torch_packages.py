"""One test body, two packages: the names a reference test file imports,
bound to the reference's objects (``"ref"``) or to the port's
(``"port"``, whose runners are made on the CPU).

A file that mirrors a reference test file case for case binds them in a
module-scoped fixture parametrized over both packages, so each case runs
once against ``presto_tpu`` and once against ``presto_tpu_torch``::

    @pytest.fixture(scope="module", params=PACKAGES, autouse=True)
    def package(request):
        bind(globals(), request.param)
        return request.param

An import inside a test body goes through :func:`module`."""

from __future__ import annotations

import functools
import importlib

PACKAGES = ["ref", "port"]
ROOTS = {"ref": "presto_tpu", "port": "presto_tpu_torch"}

#: name -> (submodule, attribute); None = the submodule itself
NAMES = {
    "T": ("types", None),
    "create_connector": ("connectors", "create_connector"),
    "TableHandle": ("connectors.spi", "TableHandle"),
    "LocalQueryRunner": ("exec.local_runner", "LocalQueryRunner"),
    "CatalogManager": ("exec.staging", "CatalogManager"),
    "PlanningError": ("plan.planner", "PlanningError"),
    "IngestManager": ("server.ingest", "IngestManager"),
    "ManifestStore": ("server.manifests", "ManifestStore"),
    "faults": ("utils.faults", None),
    "REGISTRY": ("utils.metrics", "REGISTRY"),
}


def module(pkg: str, sub: str):
    """``<package>.<sub>`` of the package a name of ``pkg`` (``"ref"``,
    ``"port"``, or a root module name) stands for."""
    root = ROOTS.get(pkg, pkg)
    return importlib.import_module(f"{root}.{sub}" if sub else root)


def bind(namespace: dict, pkg: str) -> None:
    """Bind :data:`NAMES` in ``namespace`` to ``pkg``'s objects, and
    ``PKG`` to the package's root name. The port's ``LocalQueryRunner``
    is bound with ``device="cpu"``."""
    namespace["PKG"] = ROOTS[pkg]
    for name, (sub, attr) in NAMES.items():
        mod = module(pkg, sub)
        obj = mod if attr is None else getattr(mod, attr)
        if name == "LocalQueryRunner" and pkg == "port":
            obj = functools.partial(obj, device="cpu")
        namespace[name] = obj


def split_ranges(conn, handle, **kw) -> list:
    """Every split of ``conn.get_splits(handle, **kw)`` as
    ``(row_start, row_end)``."""
    src = conn.get_splits(handle, **kw)
    out = []
    while not src.exhausted:
        out.extend((s.row_start, s.row_end) for s in src.next_batch(64))
    return out


def assert_rows_equal(got, want, rel: float = 1e-9) -> None:
    """Row lists equal in order: doubles within ``rel``, every other
    value (ints, decimals, dates, strings, NULLs) exactly."""
    assert len(got) == len(want), (len(got), len(want))
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        for a, b in zip(g, w):
            if isinstance(a, float) and isinstance(b, float):
                assert abs(a - b) <= rel * max(abs(a), abs(b)), (g, w)
            else:
                assert a == b and type(a) is type(b), (g, w)
