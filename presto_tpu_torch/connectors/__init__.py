"""Connector SPI + the built-in ``tpch``, ``tpcds``, ``memory`` and
``blackhole`` connectors.

The SPI, the tpch and tpcds generators, the writable memory connector
and the blackhole null source/sink are copies of the reference's
(``presto_tpu/connectors``); the file connectors come in a later slice.
"""

from presto_tpu_torch.connectors.spi import (  # noqa: F401
    Connector,
    ConnectorMetadata,
    ConnectorSplit,
    SplitSource,
    TableHandle,
)
from presto_tpu_torch.connectors.blackhole import (  # noqa: F401
    BlackholeConnector,
)
from presto_tpu_torch.connectors.memory import MemoryConnector  # noqa: F401
from presto_tpu_torch.connectors.tpcds import TpcdsConnector  # noqa: F401
from presto_tpu_torch.connectors.tpch import TpchConnector  # noqa: F401

CONNECTOR_FACTORIES = {
    "tpch": TpchConnector,
    "tpcds": TpcdsConnector,
    "memory": MemoryConnector,
    "blackhole": BlackholeConnector,
}


def create_connector(name: str, **config) -> Connector:
    """The ConnectorFactory seam (``connector.name=`` in catalog config)."""
    if name not in CONNECTOR_FACTORIES:
        raise KeyError(f"unknown connector: {name}")
    return CONNECTOR_FACTORIES[name](**config)
