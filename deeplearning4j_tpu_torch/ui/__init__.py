"""Observability pipeline (reference: deeplearning4j-ui-parent, ~30k LoC).

Capability map:
- StatsListener (ui/stats.py)       <- BaseStatsListener.java:51,103-124
- storage SPI + impls (ui/storage.py) <- api/storage/StatsStorage.java:
  InMemoryStatsStorage / FileStatsStorage (append-only log) /
  SqliteStatsStorage (indexed durable store — the MapDBStatsStorage /
  J7FileStatsStorage analog)
- compact wire codec (ui/codec.py)  <- SBE-generated codecs (ui/stats/sbe/)
- dashboard server (ui/server.py)   <- PlayUIServer + TrainModule routes
  (/train/overview, /train/model, /train/flow, /train/system) +
  RemoteReceiverModule
- report DSL (ui/components.py)     <- deeplearning4j-ui-components'
  chart/table/text Component JSON + standalone rendering
- standalone report (ui/report.py)  <- ui-components report path + the
  FlowListenerModule layer-graph view, server-free HTML artifact

The port of the JAX package's ui/: the same records, codec bytes, files,
routes and JSON, so a stats file or a remote stream written by either
package reads in the other.
"""

from deeplearning4j_tpu_torch.ui.stats import (ConvolutionalIterationListener,
    StatsListener)
from deeplearning4j_tpu_torch.ui.storage import (
    FileStatsStorage,
    InMemoryStatsStorage,
    RemoteUIStatsStorageRouter,
    SqliteStatsStorage,
    StatsStorage,
)
from deeplearning4j_tpu_torch.ui.server import UIServer
from deeplearning4j_tpu_torch.ui.components import (
    ChartHistogram,
    ChartLine,
    ChartScatter,
    Component,
    ComponentDiv,
    ComponentTable,
    ComponentText,
    render_page,
)
from deeplearning4j_tpu_torch.ui.report import (
    FlowGraph,
    render_training_report,
    write_training_report,
)

__all__ = [
    "ConvolutionalIterationListener",
    "StatsListener",
    "StatsStorage",
    "InMemoryStatsStorage",
    "FileStatsStorage",
    "SqliteStatsStorage",
    "RemoteUIStatsStorageRouter",
    "UIServer",
    "Component",
    "ComponentText",
    "ComponentTable",
    "ComponentDiv",
    "ChartLine",
    "ChartHistogram",
    "ChartScatter",
    "FlowGraph",
    "render_page",
    "render_training_report",
    "write_training_report",
]
