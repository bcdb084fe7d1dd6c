"""Connector SPI + the built-in ``tpch``, ``tpcds`` and ``memory``
connectors.

The SPI, the tpch and tpcds generators and the memory connector are
copies of the reference's (``presto_tpu/connectors``); the other
connectors come in later slices.
"""

from presto_tpu_torch.connectors.spi import (  # noqa: F401
    Connector,
    ConnectorMetadata,
    ConnectorSplit,
    SplitSource,
    TableHandle,
)
from presto_tpu_torch.connectors.memory import MemoryConnector  # noqa: F401
from presto_tpu_torch.connectors.tpcds import TpcdsConnector  # noqa: F401
from presto_tpu_torch.connectors.tpch import TpchConnector  # noqa: F401

CONNECTOR_FACTORIES = {
    "tpch": TpchConnector,
    "tpcds": TpcdsConnector,
    "memory": MemoryConnector,
}


def create_connector(name: str, **config) -> Connector:
    """The ConnectorFactory seam (``connector.name=`` in catalog config)."""
    if name not in CONNECTOR_FACTORIES:
        raise KeyError(f"unknown connector: {name}")
    return CONNECTOR_FACTORIES[name](**config)
