"""Robust folds over the per-client transmit stack (--robust_agg).

Port of ``commefficient_tpu/core/robust.py`` (``clip_factors`` :41,
``_masked_median`` :55, ``_masked_trimmed_mean`` :72, ``_group_means``
:91, ``robust_fold`` :108). The plain fold is the datapoint-weighted
mean Σ transmit / Σ datapoints, which one sign-flipped or rescaled
client corrupts; these estimators replace it over the round's
per-client transmits:

  median   coordinate-wise median of the per-client (or grouped)
           per-datapoint means: the mean of sorted ranks (k-1)//2 and
           k//2 of the k alive rows
  trimmed  coordinate-wise mean without floor(frac * k) rows of each
           tail
  clip     each client's transmit scaled down to a norm cap tau
           (--robust_clip_norm, or the median alive norm when 0)
           before the plain datapoint-weighted sum

Every estimator is mask-aware: a slot whose mask row is all zero (a
padded or dropped client) carries no datapoints and enters no
statistic (dead rows sort to +inf past every alive value), and a round
with no alive client folds to zeros. The server only ever sees the
robust aggregate, so rejected mass never enters its momentum or error.
Given a ``probes`` dict the fold also writes its
``fold_rejection_rate`` probe (reference :176-180): the robust
aggregate's distance from the plain fold, relative to the plain
fold's norm.
"""

from __future__ import annotations

import torch

# guards x/0 without perturbing any realistic norm
_TINY = 1e-12


def clip_factors(norms: torch.Tensor, tau) -> torch.Tensor:
    """Per-vector norm-clip scale min(1, tau / max(norm, tiny)): exactly
    1 inside the cap, 0 for an all-zero vector. The one clip algebra of
    the ``clip`` fold and the DP clip (privacy/mechanism.py); ``tau`` is
    a float or a tensor that broadcasts against ``norms``."""
    if not isinstance(tau, torch.Tensor):
        # filled on the device (a host scalar copied up would stop the
        # host), and a true division: a Python float over a tensor
        # would multiply by the reciprocal
        tau = torch.full_like(norms, float(tau))
    return torch.clamp(tau / torch.clamp(norms, min=_TINY), max=1.0)


def _sorted_alive(vals: torch.Tensor, alive: torch.Tensor):
    """The (G, D) values sorted along the client axis with the dead
    rows at +inf, and the alive count."""
    inf = torch.full((), float("inf"), dtype=vals.dtype, device=vals.device)
    s = torch.sort(torch.where(alive[:, None], vals, inf), dim=0).values
    return s, torch.sum(alive.to(torch.int32))


def _masked_median(vals: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median over the alive rows of ``vals`` (G, D):
    the mean of sorted ranks (k-1)//2 and k//2 (the same rank for odd
    k), gathered on the device. ``torch.median`` would give the lower
    of the two. All-dead input gives zeros."""
    G = vals.shape[0]
    s, k = _sorted_alive(vals, alive)
    lo = torch.clamp(torch.div(k - 1, 2, rounding_mode="floor"), 0, G - 1)
    hi = torch.clamp(torch.div(k, 2, rounding_mode="floor"), 0, G - 1)
    med = 0.5 * (s.index_select(0, lo.reshape(1))[0]
                 + s.index_select(0, hi.reshape(1))[0])
    return torch.where(k > 0, med, torch.zeros_like(med))


def _masked_trimmed_mean(vals: torch.Tensor, alive: torch.Tensor,
                         trim_frac: float) -> torch.Tensor:
    """Coordinate-wise trimmed mean over the alive rows of ``vals``
    (G, D): t = floor(frac * k) rows trimmed from each tail
    (frac < 0.5, so the window keeps a row for every k >= 1). The
    ``where`` keeps the dead rows' +inf out of the sum."""
    G = vals.shape[0]
    s, k = _sorted_alive(vals, alive)
    t = torch.floor(trim_frac * k.to(vals.dtype)).to(torch.int32)
    ranks = torch.arange(G, dtype=torch.int32, device=vals.device)[:, None]
    wm = (ranks >= t) & (ranks < k - t)
    kept = torch.sum(torch.where(wm, s, torch.zeros((), dtype=s.dtype,
                                                    device=s.device)), dim=0)
    denom = torch.clamp(torch.sum(wm.to(vals.dtype), dim=0), min=1.0)
    return kept / denom


def _group_means(flat_t: torch.Tensor, n: torch.Tensor, alive: torch.Tensor,
                 groups: int):
    """W clients -> ``groups`` contiguous groups: each group's
    datapoint-weighted mean (G, D), so honest members dilute a
    byzantine one before the median, and whether any member is alive
    (G,)."""
    W, D = flat_t.shape
    assert W % groups == 0, (W, groups)
    gsum = flat_t.reshape(groups, W // groups, D).sum(dim=1)
    gn = n.reshape(groups, W // groups).sum(dim=1)
    galive = torch.any(alive.reshape(groups, W // groups), dim=1)
    return gsum / torch.clamp(gn, min=1.0)[:, None], galive


def robust_fold(cfg, transmit: torch.Tensor, batch: dict,
                weights=None, probes=None) -> torch.Tensor:
    """The robust fold of the per-client transmit stack ``transmit``
    (W, *transmit_shape), each client's transmit already scaled by its
    datapoint count; ``batch["mask"]`` is the (W, B) aliveness mask.
    Returns the aggregate, transmit_shape, at the plain fold's
    per-datapoint-mean scale. ``weights`` ((W,) > 0) scales each
    client's transmit and datapoint count before any statistic. Under
    ``--dp sketch`` the clip fold divides by the static W·B capacity,
    as the plain DP fold does (core/rounds.py). ``probes``, a dict,
    receives ``fold_rejection_rate``."""
    W = transmit.shape[0]
    flat_t = transmit.reshape(W, -1).to(torch.float32)
    mask = batch["mask"]
    n = torch.sum(mask.reshape(W, -1), dim=1).to(torch.float32)
    if weights is not None:
        w = weights.to(torch.float32)
        flat_t = w[:, None] * flat_t
        n = w * n
    alive = n > 0
    if getattr(cfg, "dp", "off") == "sketch":
        total = torch.full((), float(mask.numel()), dtype=torch.float32,
                           device=flat_t.device)
    else:
        total = torch.clamp(torch.sum(n), min=1.0)
    # per-datapoint client means: one big-batch client cannot dominate
    # the estimators by its weight
    g = flat_t / torch.clamp(n, min=1.0)[:, None]

    mode = cfg.robust_agg
    if mode == "median":
        groups = cfg.robust_median_groups
        if 1 < groups < W:
            gv, galive = _group_means(flat_t, n, alive, groups)
        else:
            gv, galive = g, alive
        agg = _masked_median(gv, galive)
    elif mode == "trimmed":
        agg = _masked_trimmed_mean(g, alive, cfg.robust_trim_frac)
    elif mode == "clip":
        # accumulated in f64: each norm is its correctly rounded f32
        # value on any device, whatever order the reduction takes
        norms = torch.linalg.vector_norm(g, dim=1, dtype=torch.float64
                                         ).to(torch.float32)
        if cfg.robust_clip_norm > 0:
            tau = cfg.robust_clip_norm
        else:
            tau = _masked_median(norms[:, None], alive)[0]
        scale = clip_factors(norms, tau)
        # clipped transmits keep their datapoint weights: the plain
        # fold when nothing clips. Summed client by client in slot
        # order, so the card and the CPU add in the same order
        terms = (scale[:, None] * flat_t).unbind(0)
        agg = terms[0]
        for term in terms[1:]:
            agg = agg + term
        agg = agg / total
    else:
        raise ValueError(f"unknown robust_agg {mode!r}")
    if probes is not None:
        plain = torch.sum(flat_t, dim=0) / total
        probes["fold_rejection_rate"] = (
            torch.linalg.vector_norm(plain - agg)
            / torch.clamp(torch.linalg.vector_norm(plain), min=_TINY))
    return agg.reshape(transmit.shape[1:])
