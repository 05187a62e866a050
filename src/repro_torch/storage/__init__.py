"""Out-of-core partition storage: the disk tier under ``PartitionStore``.

  format.py      — versioned graph-directory layout (manifest.json +
                   content-addressed part-<pid>-<key>.npz shards, sha256
                   checksums), DiskCatalog, OutOfCorePartitionedGraph; the
                   same files as the JAX package's, so either package
                   opens the other's directories
  host_cache.py  — the pinned-host LRU between disk and device, with
                   background-thread read-ahead
"""
from .format import (DiskCatalog, FORMAT_VERSION, OutOfCorePartitionedGraph,
                     StorageFormatError, array_checksum,
                     open_partitioned_graph, save_partitioned_graph,
                     shard_name)
from .host_cache import HostArrayTier, HostBundle, HostShardCache, bundle_nbytes

__all__ = [
    "DiskCatalog", "FORMAT_VERSION", "OutOfCorePartitionedGraph",
    "StorageFormatError", "array_checksum", "open_partitioned_graph",
    "save_partitioned_graph", "shard_name",
    "HostArrayTier", "HostBundle", "HostShardCache", "bundle_nbytes",
]
