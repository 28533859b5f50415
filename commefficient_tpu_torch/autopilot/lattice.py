"""The discrete compression-knob lattice.

Port of ``commefficient_tpu/autopilot/lattice.py``: the same keys,
spellings, ladders and DP noise rescale.

The autopilot never touches a continuous knob: every runtime move is a
step between points of a small discrete lattice — wire dtype × unsketch
k × sketch rows × sketch cols × recall bucket — so each visited point
maps to exactly one round variant in the variant cache
(autopilot/cache.py) and revisiting a cached point never rebuilds it.

``apply_knobs`` is the ONE sanctioned way a Config's compression knobs
change after construction (tests/test_torch_autopilot.py scans the
port's source for direct writes elsewhere): it returns the SAME object
when the key already matches — the autopilot-off and pinned-at-base
paths therefore build from the identical Config instance and run the
same round as a build without the feature.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

from commefficient_tpu_torch.config import Config

# recall is a float flag; the lattice stores it in basis points so keys
# stay exact, hashable ints end to end (the "recall bucket")
RECALL_SCALE = 10000

# descending wire width (accounting.dtype_bytes: 4 / 2 / 1). fp8 costs
# the same bytes as int8, so it is never an automatic cheapening step —
# it enters a ladder only when the launch config already starts there.
_DTYPE_LADDER = ("f32", "bf16", "int8")

# geometry floor for automatic column-halving steps: below this the
# sketch is too collision-dense for any band to hold and the step is
# wasted lattice surface
_MIN_COLS = 64


class VariantKey(NamedTuple):
    """One lattice point == one round variant (cache key)."""
    dtype: str     # sketch wire dtype: f32 | bf16 | int8 | fp8
    k: int         # unsketch top-k
    rows: int      # sketch rows
    cols: int      # sketch cols
    recall_bp: int # approx_recall in basis points (recall bucket)


def key_of(cfg: Config) -> VariantKey:
    """The lattice point a Config currently sits at."""
    return VariantKey(str(cfg.sketch_dtype), int(cfg.k),
                      int(cfg.num_rows), int(cfg.num_cols),
                      int(round(float(cfg.approx_recall)
                                * RECALL_SCALE)))


def key_str(key: VariantKey) -> str:
    """Compact stable spelling used for ledger compile stamps, the
    manifest trajectory and --autopilot_pin:
    ``int8-k50000-r5-c500000-re9500``."""
    return (f"{key.dtype}-k{key.k}-r{key.rows}-c{key.cols}"
            f"-re{key.recall_bp}")


def parse_key(s: str) -> VariantKey:
    """Inverse of ``key_str`` (raises ValueError on malformed input)."""
    parts = s.strip().split("-")
    if len(parts) != 5 or not all(
            p.startswith(tag) for p, tag in
            zip(parts[1:], ("k", "r", "c", "re"))):
        raise ValueError(f"malformed variant key {s!r} "
                         "(want dtype-kK-rR-cC-reBP)")
    return VariantKey(parts[0], int(parts[1][1:]), int(parts[2][1:]),
                      int(parts[3][1:]), int(parts[4][2:]))


def variant_bytes(key: VariantKey) -> float:
    """Uplink wire bytes/round/client at this lattice point — the cost
    the controller minimises (identical to
    Config.upload_wire_bytes_per_client for the equivalent config)."""
    from commefficient_tpu_torch import accounting
    return accounting.sketch_wire_bytes(key.rows, key.cols, key.dtype)


def apply_knobs(cfg: Config, key: VariantKey) -> Config:
    """The sanctioned re-plan API: a Config moved to ``key``.

    Returns ``cfg`` itself (same object) when the knobs already match,
    so the base variant's round build is bit-for-bit the build a
    feature-less runtime performs. The replaced copy keeps every
    non-knob field — including the runtime-populated ``grad_size``.

    Under ``--dp sketch`` a rows-changing move recalibrates
    ``dp_noise_mult`` by sqrt(rows_base/rows_new): the mechanism's
    table noise std is σ·sqrt(rows)·clip/W (privacy/mechanism.py), so
    the rescale holds the ABSOLUTE noise at the launch calibration —
    the variant's σ is what the accountant charges that round
    (runtime/fed_model.py _charge_privacy)."""
    if key_of(cfg) == key:
        return cfg
    knobs = dict(sketch_dtype=key.dtype, k=key.k,
                 num_rows=key.rows, num_cols=key.cols,
                 approx_recall=key.recall_bp / RECALL_SCALE)
    if (str(getattr(cfg, "dp", "off")) != "off"
            and key.rows != int(cfg.num_rows)):
        knobs["dp_noise_mult"] = float(cfg.dp_noise_mult) * math.sqrt(
            int(cfg.num_rows) / key.rows)
    return cfg.replace(**knobs)


def parse_band(band: str) -> Tuple[float, float]:
    """``--autopilot_band LO:HI`` -> (lo, hi) recovery-error band."""
    try:
        lo_s, hi_s = band.split(":")
        lo, hi = float(lo_s), float(hi_s)
    except ValueError:
        raise ValueError(
            f"--autopilot_band must be LO:HI (got {band!r})") from None
    if not (0.0 <= lo < hi):
        raise ValueError(
            f"--autopilot_band needs 0 <= LO < HI (got {band!r})")
    return lo, hi


def band_str(band: Tuple[float, float]) -> str:
    """Canonical compact spelling, shared with the perf-gate topology
    fragment: ``(0.2, 0.6) -> "0.2-0.6"`` (``:`` is not filename- or
    key-safe)."""
    def fmt(x: float) -> str:
        s = f"{x:g}"
        return s
    return f"{fmt(band[0])}-{fmt(band[1])}"


def build_ladder(cfg: Config) -> List[VariantKey]:
    """Cost-ordered lattice walk for this run, most expensive (safest)
    first. Index 0 is always the launch config's own point; each later
    entry is strictly cheaper on the wire, so the controller's
    "cheapen" move is always index + 1 and "back off" index - 1.

    The default ladder walks the dtype axis only — those moves preserve
    every state shape (sketch geometry, hence ServerState momentum/EF
    tables, is untouched). ``--autopilot_geometry`` appends
    column-halving steps at the cheapest dtype; a geometry move resets
    server momentum/error (runtime/fed_model.py documents the trade).
    """
    base = key_of(cfg)
    keys = [base]
    if base.dtype in _DTYPE_LADDER:
        start = _DTYPE_LADDER.index(base.dtype)
        for dt in _DTYPE_LADDER[start + 1:]:
            keys.append(base._replace(dtype=dt))
    if bool(getattr(cfg, "autopilot_geometry", False)):
        axis = max(1, int(getattr(cfg, "model_axis", 1)))
        tail = keys[-1]
        cols = tail.cols
        while (cols % 2 == 0 and cols // 2 >= _MIN_COLS
               and (cols // 2) % axis == 0):
            cols //= 2
            keys.append(tail._replace(cols=cols))
    # strict cost monotonicity: drop any step that fails to cheapen
    # (e.g. an fp8 base has no cheaper dtype) — the controller's
    # ordering invariant must hold by construction
    ladder = [keys[0]]
    for key in keys[1:]:
        if variant_bytes(key) < variant_bytes(ladder[-1]):
            ladder.append(key)
    return ladder


def ladder_index(ladder: List[VariantKey],
                 key: VariantKey) -> Optional[int]:
    try:
        return ladder.index(key)
    except ValueError:
        return None
