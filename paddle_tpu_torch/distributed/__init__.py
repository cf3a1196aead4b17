"""The sparse-table path of the port: host-resident embedding tables in
shards, an in-process client, and the program wiring of a table
(``sparse_table``)."""

from .sparse_table import (DistributedEmbedding, SparseTableClient,
                           SparseTableShard, server_state)

__all__ = ["DistributedEmbedding", "SparseTableClient", "SparseTableShard",
           "server_state"]
