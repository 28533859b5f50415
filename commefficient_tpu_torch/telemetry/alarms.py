"""Declarative probe alarms (``--on_divergence``).

Port of ``commefficient_tpu/telemetry/alarms.py``: the same rules,
thresholds, actions and messages, ``slo_burn`` with ``check_slo``
(:173-174, 285-315) and the job service's ``job_starvation`` and
always-armed ``admission_rejected`` among them.

The probe layer (core/rounds.py + core/server.py, schema-v2 records)
gives every round a handful of host-side scalars; this module turns
them into actions so unattended runs fail loudly at the offending
round instead of silently training on garbage. Three rules:

``nan_inf``          — any NaN/Inf in the round's aggregated transmit
                       (``agg_nan`` + ``agg_inf`` > 0).
``residual_growth``  — the error-feedback residual norm grew by more
                       than ``--alarm_residual_ratio`` for
                       ``--alarm_residual_rounds`` CONSECUTIVE probed
                       rounds (one bad round is normal early in
                       training; a sustained geometric climb is the
                       EF-SGD divergence signature).
``recovery_error``   — relative sketch-recovery error above
                       ``--alarm_recovery_error`` (or non-finite);
                       1.0 means the recovered top-k is no better
                       than applying nothing.
``step_time_regression`` — the round's wall step time drifted more
                       than ``--alarm_step_time_ratio`` x above the
                       run's rolling median (window
                       ``--alarm_step_time_window``, after a short
                       warmup that skips compile rounds). A
                       *performance* alarm, not an algorithmic one:
                       it catches the slow bleed (fragmentation, a
                       background compile storm, thermal throttle)
                       that end-of-run means average away. Evaluated
                       on synchronous rounds only — pipelined
                       dispatch times measure the host, not the
                       round.
``byzantine_suspect`` — a per-client transmit-norm outlier:
                       ``client_norm_max`` above
                       ``--alarm_byzantine_ratio`` x
                       ``client_norm_mean``. Sign-flip hides inside
                       the norm distribution; scaling/noise attacks
                       stick out here even when a robust fold has
                       already neutralised them — the operator wants
                       the *name* of the problem, not just survival.
``fold_rejection_rate`` — the robust fold (``--robust_agg``)
                       deviated from the plain mean by more than
                       ``--alarm_fold_rejection`` (relative). High
                       rejection means the fold is actively fighting
                       someone; sustained high rejection on honest
                       data means the trim/clip is set too tight.
``async_staleness``  — buffered-arrival health (``--async_buffer_size``
                       runs): the round folded an update staler than
                       ``--alarm_async_staleness`` rounds. A growing
                       max staleness means the arrival process is
                       outrunning the fold cadence (the buffer drains
                       older and older mass) — the serving analogue
                       of the residual-growth rule.
``privacy_budget_exhausted`` — DP runs (``--dp sketch``) with a hard
                       budget (``--dp_epsilon`` > 0): the accountant's
                       cumulative ε(δ) reached the budget. The runtime
                       routes the post-round ε through ``check`` as
                       the ``dp_epsilon`` probe (stamped on the v5
                       record either way), so under ``--on_divergence
                       abort`` the run stops AT the first round whose
                       release exhausted the budget — the noised
                       table was already released, so the abort is
                       "spend no further", not "unrelease". The alarm
                       dict carries ``rounds_left`` (the accountant's
                       pre-charge projection, 0 when already over) so
                       the ledger names the predicted exhaustion
                       round.
``job_starvation``   — job service health (fedservice/): a
                       runnable job waited more than
                       ``--alarm_job_starvation`` scheduler ticks
                       since it last ran. Fired by the daemon's OWN
                       alarm engine against its fairness probes (the
                       per-job engines never see other jobs), so a
                       greedy scheduling policy that starves a tenant
                       fails loudly instead of silently serving one
                       job's traffic.
``admission_rejected`` — a JobSpec was refused at admission (capacity,
                       duplicate id/seed — the ``admission_rejected``
                       probe counts this tick's refusals). Always
                       armed on the daemon's engine, like ``nan_inf``:
                       a rejected manifest is an operator-visible
                       event whatever the thresholds say.
``slo_burn``         — declarative SLO health (telemetry/slo.py): the
                       run's worst multi-window error-budget burn
                       rate (``slo_burn_max`` probe) reached
                       ``--alarm_slo_burn``. Burn 1.0 means the run
                       is consuming its error budget exactly as fast
                       as the budget allows; the conventional paging
                       threshold is well above 1 (e.g. 2: the budget
                       dies in half its window). Evaluated via
                       ``check_slo`` on runs with their own SLO
                       engine, or through ``check`` when the SLO
                       probes arrive merged (the fedservice daemon's
                       fairness tick). Fires once per burning round —
                       the flight recorder's one-bundle-per-rule
                       policy keeps the postmortem volume bounded.
``collective_skew``  — trace-derived (schema-v4 ``device_time``): a
                       profiled round's straggler wait dominates its
                       collective bucket — max cross-device
                       enter-delta above ``--alarm_collective_skew``
                       x the round's collective seconds. The fleet
                       version of the step-time rule: one slow
                       participant taxes every device in the mesh,
                       and the skew decomposition names it. Only
                       rounds inside a trace window are evaluated; a
                       one-card trace has no collectives, so on the
                       port's one-card runs it never fires.

Every fired rule is appended to the round record's ``alarms`` list
(when a ledger is attached) regardless of action. The action then
escalates: ``log`` warns, ``ledger-flag`` stays silent outside the
ledger, ``abort`` raises :class:`DivergenceAbort` — the trainers
catch it, flush telemetry (the flagged record becomes the run's final
round record) and stop, exactly like the existing NaN-loss path.
"""

from __future__ import annotations

import logging
import math
from collections import deque
from statistics import median

logger = logging.getLogger("commefficient_tpu_torch.telemetry.alarms")

ACTIONS = ("log", "ledger-flag", "abort")


class DivergenceAbort(RuntimeError):
    """A probe alarm fired under ``--on_divergence abort``."""

    def __init__(self, round_index: int, alarms):
        self.round_index = int(round_index)
        self.alarms = list(alarms)
        rules = ", ".join(a["rule"] for a in self.alarms)
        super().__init__(
            f"probe alarm(s) [{rules}] at round {round_index}")


def _finite(v):
    return v is not None and math.isfinite(v)


class AlarmEngine:
    """Evaluates the alarm rules against each round's probe dict.

    Stateful only for the consecutive-rounds residual rule; one
    engine observes one run. ``telemetry`` may be a disabled
    Telemetry (alarms still evaluate and can still abort — the
    ledger flag is just unrecorded)."""

    #: step-time samples required before the regression rule arms —
    #: the first rounds carry compile/warmup time and are not signal
    STEP_TIME_WARMUP = 5

    def __init__(self, cfg, telemetry=None):
        assert cfg.on_divergence in ACTIONS, cfg.on_divergence
        self.action = cfg.on_divergence
        self.residual_ratio = float(cfg.alarm_residual_ratio)
        self.residual_rounds = int(cfg.alarm_residual_rounds)
        self.recovery_error = float(cfg.alarm_recovery_error)
        self.step_time_ratio = float(
            getattr(cfg, "alarm_step_time_ratio", 0.0) or 0.0)
        self.step_time_window = int(
            getattr(cfg, "alarm_step_time_window", 16) or 16)
        self.collective_skew = float(
            getattr(cfg, "alarm_collective_skew", 0.0) or 0.0)
        self.byzantine_ratio = float(
            getattr(cfg, "alarm_byzantine_ratio", 0.0) or 0.0)
        self.fold_rejection = float(
            getattr(cfg, "alarm_fold_rejection", 0.0) or 0.0)
        self.async_staleness = float(
            getattr(cfg, "alarm_async_staleness", 0.0) or 0.0)
        self.job_starvation = float(
            getattr(cfg, "alarm_job_starvation", 0.0) or 0.0)
        self.slo_burn = float(
            getattr(cfg, "alarm_slo_burn", 0.0) or 0.0)
        self.privacy_budget = (
            float(getattr(cfg, "dp_epsilon", 0.0) or 0.0)
            if str(getattr(cfg, "dp", "off")) != "off" else 0.0)
        self.telemetry = telemetry
        self._consecutive = 0
        self._step_times = deque(maxlen=self.step_time_window)

    def check(self, round_index: int, probes) -> list:
        """Run every rule on one round's probes. Returns the fired
        alarm dicts (empty for a healthy round); flags them on the
        ledger record, then escalates per the configured action —
        ``abort`` raises :class:`DivergenceAbort` AFTER flagging so
        the record that reaches the sink carries its alarms."""
        if not probes:
            return []
        fired = []

        bad = (probes.get("agg_nan") or 0) + (probes.get("agg_inf")
                                              or 0)
        if bad > 0:
            fired.append({"rule": "nan_inf", "value": float(bad),
                          "threshold": 0.0})

        growth = probes.get("residual_growth")
        if growth is not None:
            if not _finite(growth) or growth > self.residual_ratio:
                self._consecutive += 1
            else:
                self._consecutive = 0
            if self._consecutive >= self.residual_rounds:
                fired.append({"rule": "residual_growth",
                              "value": float(growth),
                              "threshold": self.residual_ratio,
                              "consecutive": self._consecutive})

        rerr = probes.get("recovery_error")
        if rerr is not None and (not _finite(rerr)
                                 or rerr > self.recovery_error):
            fired.append({"rule": "recovery_error",
                          "value": float(rerr),
                          "threshold": self.recovery_error})

        if self.byzantine_ratio > 0:
            cmax = probes.get("client_norm_max")
            cmean = probes.get("client_norm_mean")
            if cmax is not None and cmean is not None:
                ratio = (float(cmax) / float(cmean)
                         if float(cmean) > 0 else
                         (math.inf if float(cmax) > 0 else 0.0))
                if not _finite(ratio) \
                        or ratio > self.byzantine_ratio:
                    fired.append({"rule": "byzantine_suspect",
                                  "value": float(ratio),
                                  "threshold": self.byzantine_ratio,
                                  "client_norm_max": float(cmax),
                                  "client_norm_mean": float(cmean)})

        if self.fold_rejection > 0:
            frr = probes.get("fold_rejection_rate")
            if frr is not None and (not _finite(frr)
                                    or frr > self.fold_rejection):
                fired.append({"rule": "fold_rejection_rate",
                              "value": float(frr),
                              "threshold": self.fold_rejection})

        if self.async_staleness > 0:
            smax = probes.get("async_staleness_max")
            if smax is not None and (not _finite(smax)
                                     or smax > self.async_staleness):
                fired.append({
                    "rule": "async_staleness",
                    "value": float(smax),
                    "threshold": self.async_staleness,
                    "buffer_occupancy": probes.get(
                        "async_buffer_occupancy"),
                    "backlog": probes.get("async_backlog")})

        if self.job_starvation > 0:
            waited = probes.get("job_starved_rounds")
            if waited is not None and (not _finite(waited)
                                       or waited > self.job_starvation):
                fired.append({
                    "rule": "job_starvation",
                    "value": float(waited),
                    "threshold": self.job_starvation,
                    "job": probes.get("job_starved_index"),
                    "occupancy": probes.get("job_occupancy_min")})

        fired.extend(self._slo_rule(probes))

        rejected = probes.get("admission_rejected")
        if rejected is not None and float(rejected) > 0:
            fired.append({"rule": "admission_rejected",
                          "value": float(rejected),
                          "threshold": 0.0})

        if self.privacy_budget > 0:
            eps = probes.get("dp_epsilon")
            if eps is not None and (not _finite(eps)
                                    or eps >= self.privacy_budget):
                fired.append({
                    "rule": "privacy_budget_exhausted",
                    "value": float(eps),
                    "threshold": self.privacy_budget,
                    "dp_delta": probes.get("dp_delta"),
                    "dp_sigma": probes.get("dp_sigma"),
                    "rounds_left": probes.get("dp_rounds_left")})

        return self._escalate(round_index, fired)

    def _slo_rule(self, probes) -> list:
        """The ``slo_burn`` rule body (no escalation — callers own
        that): fires when the worst per-objective burn rate reaches
        ``--alarm_slo_burn``. The alarm dict carries every
        ``slo_burn_*`` probe so the ledger names WHICH objective is
        burning, not just that one is."""
        if self.slo_burn <= 0:
            return []
        burn = probes.get("slo_burn_max")
        if burn is None:
            return []
        if _finite(burn) and burn < self.slo_burn:
            return []
        alarm = {"rule": "slo_burn", "value": float(burn),
                 "threshold": self.slo_burn}
        for key, v in sorted(probes.items()):
            if key.startswith("slo_burn_") and key != "slo_burn_max":
                alarm[key] = None if v is None else float(v)
        return [alarm]

    def check_slo(self, round_index: int, slo_probes) -> list:
        """Evaluate ONLY the ``slo_burn`` rule on one round's SLO
        probes. The runtime routes the SLO engine's output here
        (rather than through ``check``) because ``check`` is stateful
        — calling it twice per round would double-advance the
        consecutive-residual counter. Same flag/log/abort escalation
        as every other rule."""
        if not slo_probes:
            return []
        return self._escalate(round_index,
                              self._slo_rule(slo_probes))

    def check_step_time(self, round_index: int, step_s: float) -> list:
        """``step_time_regression``: fires when this round's wall
        step time exceeds ``step_time_ratio`` x the rolling median of
        the last ``step_time_window`` rounds (after warmup). The
        offending sample is NOT folded into the window — a sustained
        regression keeps firing instead of re-normalising itself.
        Same flag/log/abort escalation as the probe rules."""
        if self.step_time_ratio <= 0:
            return []
        step_s = float(step_s)
        if len(self._step_times) < self.STEP_TIME_WARMUP:
            self._step_times.append(step_s)
            return []
        med = median(self._step_times)
        threshold = self.step_time_ratio * med
        if med <= 0 or step_s <= threshold:
            self._step_times.append(step_s)
            return []
        fired = [{"rule": "step_time_regression",
                  "value": step_s, "threshold": threshold,
                  "rolling_median": med}]
        return self._escalate(round_index, fired)

    def check_device_time(self, round_index: int, buckets) -> list:
        """``collective_skew``: fires when a traced round's max
        cross-device enter-delta (telemetry/trace.py skew stats)
        exceeds ``collective_skew`` x the round's collective bucket.
        Wired as ``Telemetry.on_device_time`` so it runs when trace
        buckets merge — after the round closed, before emission (the
        flagged record still reaches the sink with its alarms)."""
        if self.collective_skew <= 0 or not buckets:
            return []
        skew = buckets.get("skew") or {}
        delta = skew.get("max_enter_delta_s")
        coll = float(buckets.get("collective_s") or 0.0)
        if delta is None or coll <= 0:
            return []
        threshold = self.collective_skew * coll
        if float(delta) <= threshold:
            return []
        fired = [{"rule": "collective_skew",
                  "value": float(delta), "threshold": threshold,
                  "collective_s": coll,
                  "straggler_device": skew.get("straggler_device")}]
        return self._escalate(round_index, fired)

    def _escalate(self, round_index: int, fired: list) -> list:
        """Shared escalation tail: flag the ledger record, then act —
        ``abort`` raises AFTER flagging so the record that reaches the
        sink carries its alarms."""
        if not fired:
            return []
        for alarm in fired:
            alarm["round"] = int(round_index)
            alarm["action"] = self.action
            if self.telemetry is not None:
                self.telemetry.flag_alarm(round_index, alarm)
        if self.action != "ledger-flag":
            for alarm in fired:
                logger.warning(
                    "probe alarm %s at round %d: value %.6g over "
                    "threshold %.6g", alarm["rule"], round_index,
                    alarm["value"], alarm["threshold"])
        if self.action == "abort":
            raise DivergenceAbort(round_index, fired)
        return fired


def build_alarm_engine(cfg, telemetry=None):
    """An engine when probes are on or the step-time / collective-skew
    rules are armed, else None (no per-round call)."""
    if (getattr(cfg, "probe_period", 0)
            or float(getattr(cfg, "alarm_step_time_ratio", 0.0)
                     or 0.0) > 0
            or float(getattr(cfg, "alarm_collective_skew", 0.0)
                     or 0.0) > 0
            or float(getattr(cfg, "alarm_byzantine_ratio", 0.0)
                     or 0.0) > 0
            or float(getattr(cfg, "alarm_fold_rejection", 0.0)
                     or 0.0) > 0
            or float(getattr(cfg, "alarm_async_staleness", 0.0)
                     or 0.0) > 0
            or float(getattr(cfg, "alarm_job_starvation", 0.0)
                     or 0.0) > 0
            or float(getattr(cfg, "alarm_slo_burn", 0.0)
                     or 0.0) > 0
            or (str(getattr(cfg, "dp", "off")) != "off"
                and float(getattr(cfg, "dp_epsilon", 0.0) or 0.0)
                > 0)):
        return AlarmEngine(cfg, telemetry)
    return None
