"""The one place the port's raw wall and interval clocks live.

Port of ``commefficient_tpu/telemetry/clock.py``. The port's modules
time through these aliases, or better through ``Telemetry.span``.

``wall``  -- epoch seconds, for timestamps read beside logs.
``tick``  -- monotonic high-resolution clock, for intervals and spans.
"""

from __future__ import annotations

import time

wall = time.time
tick = time.perf_counter
