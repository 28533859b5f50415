"""Declarative per-job SLOs with multi-window error-budget burn rates.

Port of ``commefficient_tpu/telemetry/slo.py`` (``SLOSpec`` :40,
``_Objective`` :93, ``SLOEngine`` :122, ``build_slo_engine`` :219), line
for line: the same objectives, windows, warmup and linear privacy
schedule, so the same float stream gives the same burns and stamps.

An SLO here is a statement about the round stream — "p95 round
latency under T seconds", "staleness never above S rounds", "ε spend
no faster than linear to the planned horizon", "no job starved more
than K ticks" — plus an **error budget**: the fraction of rounds
allowed to violate it (``--slo_error_budget``, default 5%, which is
exactly what a p95 target means). The engine does no alerting on a
single bad round. Instead it tracks the violation rate over TWO
rolling windows (``--slo_fast_window`` / ``--slo_window``) and
reports each objective's **burn rate**: violation rate over budget.
A burn of 1.0 means the job is spending its error budget exactly as
fast as the SLO allows; 2.0 means twice as fast.

The alarm condition is the classic multi-window rule: fire only when
BOTH windows burn hot — the fast window proves the problem is
happening *now*, the slow window proves it is *sustained* (one slow
round after a compile never pages anyone). The reported burn per
objective is therefore ``min(fast_burn, slow_burn)``, compared by
``telemetry/alarms.py``'s ``slo_burn`` rule against
``--alarm_slo_burn`` under the shared ``--on_divergence`` action.

Everything here is plain host-side Python over floats the round
already produced — no clocks (callers measure with
``telemetry.clock``), no sockets, no threads.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

#: objective names, in the order the engine evaluates them
OBJECTIVES = ("round_latency", "staleness", "privacy_burn",
              "starvation")


@dataclass(frozen=True)
class SLOSpec:
    """One job's declarative SLO targets. A target of 0 disarms that
    objective; a spec with every target 0 builds no engine."""

    #: p95 round-latency target (seconds); a round counts against the
    #: budget when its wall seconds exceed this
    round_p95_s: float = 0.0
    #: staleness ceiling (rounds): the round's max folded staleness
    #: (``async_staleness_max`` probe) must stay at or under it
    staleness_max: float = 0.0
    #: planned privacy horizon (rounds): with a DP budget ε*, round n
    #: violates when cumulative ε exceeds the linear schedule
    #: ε* · (n+1)/horizon — spending faster than the run can afford
    eps_horizon: int = 0
    #: the ε* the linear schedule above is drawn to (``--dp_epsilon``)
    eps_budget: float = 0.0
    #: starvation bound (scheduler ticks): the fedservice fairness
    #: probe ``job_starved_rounds`` must stay at or under it
    starvation_ticks: float = 0.0
    #: allowed violation fraction per window (the error budget)
    error_budget: float = 0.05
    #: slow window (rounds) — the "sustained" half of the rule
    window: int = 32
    #: fast window (rounds) — the "happening now" half; also the
    #: warmup: no burn is reported before this many observations
    fast_window: int = 8

    @property
    def armed(self) -> bool:
        return (self.round_p95_s > 0 or self.staleness_max > 0
                or (self.eps_horizon > 0 and self.eps_budget > 0)
                or self.starvation_ticks > 0)

    @staticmethod
    def from_config(cfg) -> "SLOSpec":
        eps = (float(getattr(cfg, "dp_epsilon", 0.0) or 0.0)
               if str(getattr(cfg, "dp", "off")) != "off" else 0.0)
        return SLOSpec(
            round_p95_s=float(getattr(cfg, "slo_round_p95", 0.0)
                              or 0.0),
            staleness_max=float(getattr(cfg, "slo_staleness_max", 0.0)
                                or 0.0),
            eps_horizon=int(getattr(cfg, "slo_eps_rounds", 0) or 0),
            eps_budget=eps,
            starvation_ticks=float(getattr(cfg, "slo_starvation", 0.0)
                                   or 0.0),
            error_budget=float(getattr(cfg, "slo_error_budget", 0.05)
                               or 0.05),
            window=int(getattr(cfg, "slo_window", 32) or 32),
            fast_window=int(getattr(cfg, "slo_fast_window", 8) or 8),
        )


class _Objective:
    """One objective's rolling violation windows."""

    __slots__ = ("name", "target", "fast", "slow", "seen")

    def __init__(self, name, target, spec: SLOSpec):
        self.name = name
        self.target = float(target)
        self.fast = deque(maxlen=spec.fast_window)
        self.slow = deque(maxlen=spec.window)
        self.seen = 0

    def push(self, violated: bool):
        v = 1.0 if violated else 0.0
        self.fast.append(v)
        self.slow.append(v)
        self.seen += 1

    def burn(self, error_budget: float, warmup: int) -> float:
        """min(fast, slow) window burn; 0.0 until ``warmup``
        observations so a cold engine never alarms on its first
        sample."""
        if self.seen < warmup:
            return 0.0
        fast = sum(self.fast) / len(self.fast)
        slow = sum(self.slow) / len(self.slow)
        return min(fast, slow) / error_budget


class SLOEngine:
    """Evaluates one job's :class:`SLOSpec` over the round stream.

    ``observe`` is called once per finished round (dispatch order)
    with whatever signals the caller has; objectives whose signal is
    absent that round simply do not advance. Returns the round's SLO
    probe dict — ``slo_burn_<objective>`` per armed objective that
    advanced at least once, plus ``slo_burn_max`` — which the caller
    merges onto the ledger record and routes to the alarm engine
    (``AlarmEngine.check_slo`` or via ``check``'s probe dict)."""

    def __init__(self, spec: SLOSpec):
        assert spec.armed, "SLOEngine built from a disarmed spec"
        assert 0.0 < spec.error_budget <= 1.0, spec.error_budget
        assert 1 <= spec.fast_window <= spec.window, \
            (spec.fast_window, spec.window)
        self.spec = spec
        self._objectives = {}
        if spec.round_p95_s > 0:
            self._objectives["round_latency"] = _Objective(
                "round_latency", spec.round_p95_s, spec)
        if spec.staleness_max > 0:
            self._objectives["staleness"] = _Objective(
                "staleness", spec.staleness_max, spec)
        if spec.eps_horizon > 0 and spec.eps_budget > 0:
            self._objectives["privacy_burn"] = _Objective(
                "privacy_burn", spec.eps_budget, spec)
        if spec.starvation_ticks > 0:
            self._objectives["starvation"] = _Objective(
                "starvation", spec.starvation_ticks, spec)
        #: the most recent ``slo_burn_max`` (0.0 before any observe)
        self.last_burn = 0.0

    def observe(self, round_index: int, *, round_s=None,
                staleness_max=None, dp_epsilon=None,
                starved_ticks=None) -> dict:
        """Advance every armed objective that has a signal this round
        and return the SLO probe dict (empty when nothing armed
        advanced yet)."""
        spec = self.spec
        obj = self._objectives
        if round_s is not None and "round_latency" in obj:
            obj["round_latency"].push(
                float(round_s) > spec.round_p95_s)
        if staleness_max is not None and "staleness" in obj:
            obj["staleness"].push(
                float(staleness_max) > spec.staleness_max)
        if dp_epsilon is not None and "privacy_burn" in obj:
            # linear spend schedule: after n+1 charged rounds the run
            # may have spent ε* (n+1)/horizon of its budget
            allowed = spec.eps_budget * min(
                1.0, (obj["privacy_burn"].seen + 1)
                / spec.eps_horizon)
            obj["privacy_burn"].push(float(dp_epsilon) > allowed)
        if starved_ticks is not None and "starvation" in obj:
            obj["starvation"].push(
                float(starved_ticks) > spec.starvation_ticks)
        probes = {}
        for name, o in obj.items():
            if o.seen == 0:
                continue
            probes[f"slo_burn_{name}"] = o.burn(
                spec.error_budget, spec.fast_window)
        if probes:
            probes["slo_burn_max"] = max(probes.values())
            self.last_burn = probes["slo_burn_max"]
        return probes

    def stamp(self) -> dict:
        """The schema-v6 ``slo`` record stamp: per-objective target /
        violation-rate / burn snapshot after the latest observe."""
        spec = self.spec
        out = {}
        for name, o in self._objectives.items():
            if o.seen == 0:
                continue
            out[name] = {
                "target": o.target,
                "seen": o.seen,
                "fast_rate": round(sum(o.fast) / max(1, len(o.fast)),
                                   6),
                "slow_rate": round(sum(o.slow) / max(1, len(o.slow)),
                                   6),
                "burn": round(o.burn(spec.error_budget,
                                     spec.fast_window), 6),
            }
        return out

    @property
    def burning(self) -> bool:
        """True when the latest observed burn is at or above 1.0 —
        the job is spending error budget faster than its SLO allows.
        fedservice admission reads this to flag hot tenants before
        admitting new ones."""
        return self.last_burn >= 1.0


def build_slo_engine(cfg):
    """An :class:`SLOEngine` when any ``--slo_*`` target is armed,
    else None (no per-round call, no state)."""
    spec = SLOSpec.from_config(cfg)
    return SLOEngine(spec) if spec.armed else None
