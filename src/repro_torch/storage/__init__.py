"""Host staging tier under the partition store (host_cache.py)."""
from .host_cache import HostArrayTier, HostBundle, bundle_nbytes

__all__ = ["HostArrayTier", "HostBundle", "bundle_nbytes"]
