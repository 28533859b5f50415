"""Adaptive compression autopilot.

Port of ``commefficient_tpu/autopilot/``. A seeded, deterministic,
replayable between-rounds controller (controller.py) reads the round's
probe scalars and walks the discrete knob lattice (lattice.py) toward
the cheapest round whose sketch recovery error stays inside
``--autopilot_band LO:HI``, dispatching through a bounded LRU of round
variants (cache.py) so a revisited point is never rebuilt.

What a variant is in the port: one knob-substituted ``Config`` plus its
eager round bundle (the client round of the plain and the probed
flavor, each holding the sketch's hash and sign state for that
geometry, and the server round, built on first use). There is no XLA
compile and no ``torch.compile``: building a variant builds the round
closures and their ``CountSketch``; the kernels are the ones every
round launches. ``lattice.apply_knobs`` is the ONLY place compression
knobs change after construction (tests/test_torch_autopilot.py scans
the package's source for other writes).
"""
from commefficient_tpu_torch.autopilot.cache import RoundVariantCache
from commefficient_tpu_torch.autopilot.controller import (AutopilotController,
                                                    build_controller,
                                                    replay_record)
from commefficient_tpu_torch.autopilot.lattice import (VariantKey,
                                                 apply_knobs,
                                                 band_str,
                                                 build_ladder, key_of,
                                                 key_str, parse_band,
                                                 parse_key,
                                                 variant_bytes)

__all__ = [
    "AutopilotController", "RoundVariantCache", "VariantKey",
    "apply_knobs", "band_str", "build_controller", "build_ladder",
    "key_of", "key_str", "parse_band", "parse_key", "replay_record",
    "variant_bytes",
]
