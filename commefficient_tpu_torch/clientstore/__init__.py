"""Host-backed per-client state store (port of
``commefficient_tpu/clientstore``; see store.py for the design).

Public surface:
  HostClientStore     — budgeted numpy arena + mmap spill tier
  StorePrefetcher     — double-buffered background gather thread
  state_fields        — which fields a Config needs
  state_row_bytes     — per-client state footprint under a Config
  resolve_clientstore — build-time resolution of --clientstore auto
  shard_range         — contiguous client-id ownership of a process
"""

from commefficient_tpu_torch.clientstore.prefetch import StorePrefetcher
from commefficient_tpu_torch.clientstore.store import (HostClientStore,
                                                       resolve_clientstore,
                                                       shard_range,
                                                       state_fields,
                                                       state_row_bytes)

__all__ = [
    "HostClientStore",
    "StorePrefetcher",
    "resolve_clientstore",
    "shard_range",
    "state_fields",
    "state_row_bytes",
]
