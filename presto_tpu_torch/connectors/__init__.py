"""Connector SPI + the built-in ``tpch``, ``tpcds``, ``memory``,
``blackhole``, ``parquet``, ``orc`` and ``hive`` connectors.

The SPI, the tpch and tpcds generators, the writable memory connector,
the blackhole null source/sink and the file connectors are copies of
the reference's (``presto_tpu/connectors``). The file connectors read
through pyarrow, imported on first use: without it their factories
raise an ImportError that names pyarrow.
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



def _parquet_factory(**config):
    from presto_tpu_torch.connectors.parquet import ParquetConnector

    return ParquetConnector(**config)


def _orc_factory(**config):
    from presto_tpu_torch.connectors.orc import OrcConnector

    return OrcConnector(**config)


def _hive_factory(**config):
    from presto_tpu_torch.connectors.hive import HiveConnector

    return HiveConnector(**config)


CONNECTOR_FACTORIES = {
    "tpch": TpchConnector,
    "tpcds": TpcdsConnector,
    "memory": MemoryConnector,
    "blackhole": BlackholeConnector,
    "parquet": _parquet_factory,  # lazy: pyarrow imports on first use
    "orc": _orc_factory,
    "hive": _hive_factory,
}


def create_connector(name: str, **config) -> Connector:
    """The ConnectorFactory seam (``connector.name=`` in catalog config)."""
    if name not in CONNECTOR_FACTORIES:
        raise KeyError(f"unknown connector: {name}")
    return CONNECTOR_FACTORIES[name](**config)
