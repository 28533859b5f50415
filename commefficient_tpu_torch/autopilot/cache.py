"""Bounded LRU of round variants, keyed by the knob lattice.

Port of ``commefficient_tpu/autopilot/cache.py``. The runtime asks for
the variant at the controller's current lattice point; a hit is a dict
lookup, a miss invokes the builder (in the port: the eager round
bundle of ``runtime/fed_model.py _RoundVariant``, whose closures and
sketch state are built at once and whose kernels run at its first
dispatch), and the oldest untouched variant falls off once the bound is
exceeded. The cache is generic over entry type so tests can exercise it
with plain closures exactly as the runtime uses it with variant
bundles.

Eviction drops the bundle; a re-visit after eviction rebuilds it, which
the ledger stamping in runtime/fed_model.py makes visible as fresh
``vcompile_*:<key>`` counters on that round's record.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional


class RoundVariantCache:
    """``builder(key) -> entry``; entries are opaque to the cache."""

    def __init__(self, builder: Callable, max_size: int = 4,
                 on_evict: Optional[Callable] = None):
        assert max_size >= 1, "cache bound must be >= 1"
        self._builder = builder
        self._max = int(max_size)
        self._on_evict = on_evict
        self._entries: "OrderedDict" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return key in self._entries

    def keys(self):
        """LRU -> MRU order."""
        return list(self._entries.keys())

    def get(self, key):
        entry = self._entries.get(key)
        if entry is not None:
            self.hits += 1
            self._entries.move_to_end(key)
            return entry
        self.misses += 1
        entry = self._builder(key)
        self._entries[key] = entry
        while len(self._entries) > self._max:
            old_key, old = self._entries.popitem(last=False)
            self.evictions += 1
            if self._on_evict is not None:
                self._on_evict(old_key, old)
        return entry

    def peek(self, key):
        """Entry without touching recency or building — None on
        absence. The warm-ahead path uses this to stay side-effect-free
        on points it merely inspects."""
        return self._entries.get(key)

    def counters(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "size": len(self)}
