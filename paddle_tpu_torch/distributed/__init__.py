"""The sparse-table path of the port: host-resident embedding tables in
shards, an in-process client, and the program wiring of a table
(``sparse_table``); and the heartbeat monitor of the serving fleet
(``ps.HeartBeatMonitor``)."""

from .ps import HeartBeatMonitor
from .sparse_table import (DistributedEmbedding, SparseTableClient,
                           SparseTableShard, server_state)

__all__ = ["HeartBeatMonitor", "DistributedEmbedding", "SparseTableClient",
           "SparseTableShard", "server_state"]
