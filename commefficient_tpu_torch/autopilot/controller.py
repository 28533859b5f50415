"""The between-rounds knob controller.

Port of ``commefficient_tpu/autopilot/controller.py``
(``AutopilotController``, ``_budget_feasible``, ``build_controller``,
``replay_record``, ``key_of_config``): one observation stream gives the
same trajectory in both packages.

A deterministic, seeded, replayable policy over the knob lattice
(autopilot/lattice.py): every round whose probe dict carries a
recovery-error observation gets exactly one ``observe`` call, and the
controller either holds or moves one ladder step. The policy is pure
host-side state — no RNG is ever drawn (the seed is recorded purely so
a manifest names the stream the run's PROBES were computed under), so
replaying the recorded observations through a fresh controller
reproduces the knob sequence bit-exactly (autopilot/replay.py).

Policy (band ``LO:HI`` on relative sketch recovery error):

- error > HI        -> back off one step toward the expensive end,
                       immediately (safety beats cooldown), and lower
                       the cheap limit so the offending point is never
                       re-entered — the no-oscillation guarantee is a
                       monotone limit, not a timer;
- NaN/Inf observed  -> jump to the base (safest) point and freeze the
                       ladder (cheap limit 0);
- error < LO        -> after ``--autopilot_cooldown`` in-band rounds,
                       cheapen one step (never past the cheap limit);
- LO <= error <= HI -> hold (and pay down the cooldown).

The gap between LO and HI is the hysteresis band: a point whose error
sits inside it is stable by construction, and because the cheap limit
only ever decreases, the visited-point sequence is finite and the
controller converges on every input trace.
"""

from __future__ import annotations

from typing import List, Optional

from commefficient_tpu_torch.autopilot.lattice import (VariantKey,
                                                 apply_knobs,
                                                 build_ladder,
                                                 key_of, key_str,
                                                 ladder_index,
                                                 parse_band, parse_key,
                                                 variant_bytes)
from commefficient_tpu_torch.config import Config


class AutopilotController:
    def __init__(self, ladder: List[VariantKey], band, cooldown: int,
                 seed: int = 0, start: int = 0,
                 pinned: bool = False):
        assert ladder, "empty knob ladder"
        assert 0 <= start < len(ladder), (start, len(ladder))
        self.ladder = list(ladder)
        self.lo, self.hi = float(band[0]), float(band[1])
        self.cooldown = int(cooldown)
        self.seed = int(seed)
        self.pinned = bool(pinned)
        self.idx = int(start)
        self._cool = 0
        # cheapest index the controller may still enter; only ever
        # decreases (set one below any point whose error breached HI)
        self._cheap_limit = len(self.ladder) - 1
        self.trajectory: List[dict] = []

    @property
    def key(self) -> VariantKey:
        return self.ladder[self.idx]

    def observe(self, ridx: int, probes: dict) -> Optional[VariantKey]:
        """Feed one round's probe scalars; returns the new lattice
        point when the controller moves, None on hold. Deterministic in
        (constructor args, observation sequence) — nothing else."""
        err = probes.get("recovery_error")
        err = None if err is None else float(err)
        bad = (float(probes.get("agg_nan", 0.0)) > 0
               or float(probes.get("agg_inf", 0.0)) > 0)
        action, moved = "hold", None
        if self.pinned:
            action = "pinned"
        elif bad:
            # numeric blow-up: no band argument survives NaN — return
            # to the launch point and stop cheapening for good
            self._cheap_limit = 0
            if self.idx != 0:
                self.idx = 0
                action, moved = "panic", self.key
            self._cool = self.cooldown
        elif err is None:
            # off-cadence round (no recovery observation): hold
            # without paying down the cooldown — cooldown counts
            # OBSERVED in-band rounds, so a sparse probe cadence
            # cannot fast-forward it
            action = "blind"
        elif err > self.hi:
            self._cheap_limit = min(self._cheap_limit,
                                    max(self.idx - 1, 0))
            if self.idx > 0:
                self.idx -= 1
                action, moved = "backoff", self.key
            self._cool = self.cooldown
        elif err < self.lo and self.idx < self._cheap_limit:
            if self._cool > 0:
                self._cool -= 1
            else:
                self.idx += 1
                action, moved = "cheapen", self.key
                self._cool = self.cooldown
        else:
            self._cool = max(self._cool - 1, 0)
        self.trajectory.append({
            "round": int(ridx),
            "recovery_error": err,
            "nan": bool(bad),
            "action": action,
            "key": key_str(self.key),
        })
        return moved

    def record(self) -> dict:
        """Everything a manifest needs for bit-exact replay (plus the
        converged point for topology resolution — registry.run_band/
        run_wire_dtype read it)."""
        return {
            "band": [self.lo, self.hi],
            "cooldown": self.cooldown,
            "seed": self.seed,
            "pinned": self.pinned,
            "ladder": [key_str(k) for k in self.ladder],
            "initial": key_str(self.ladder[0]),
            "final": key_str(self.key),
            "final_wire_bytes": float(variant_bytes(self.key)),
            "initial_wire_bytes": float(
                variant_bytes(self.ladder[0])),
            "trajectory": list(self.trajectory),
        }


def _budget_feasible(cfg: Config):
    """``--dp sketch`` with a hard ε budget: a lattice point is
    feasible only if running the ENTIRE remaining run at it never
    exhausts the budget sooner than the launch point would —
    equivalently, its per-round RDP cost at the variant's
    (recalibrated) ``dp_noise_mult`` fits at least as many rounds
    under ``--dp_epsilon`` as the base σ does (privacy/accountant.py
    steps_to_budget on the composed curve). Returns the keep
    predicate; always-true when the constraint is off."""
    if (str(getattr(cfg, "dp", "off")) == "off"
            or float(getattr(cfg, "dp_epsilon", 0.0) or 0.0) <= 0
            or float(getattr(cfg, "dp_noise_mult", 0.0) or 0.0) <= 0):
        return lambda key: True
    from commefficient_tpu_torch.privacy import (sample_rate_of,
                                           steps_to_budget)
    q = sample_rate_of(cfg)
    delta = float(cfg.dp_delta)
    budget = float(cfg.dp_epsilon)
    base_rounds = steps_to_budget(float(cfg.dp_noise_mult), q,
                                  delta, budget)

    def keep(key: VariantKey) -> bool:
        sigma = float(apply_knobs(cfg, key).dp_noise_mult)
        return steps_to_budget(sigma, q, delta, budget) >= base_rounds

    return keep


def build_controller(cfg: Config) -> Optional[AutopilotController]:
    """Controller for a Config, or None with the autopilot off. The
    ladder's base is the launch config's own lattice point;
    ``--autopilot_pin`` starts (and holds) at the named point, adding
    it as a one-point ladder when it is off the automatic walk.

    Under ``--dp sketch`` with a hard budget (``--dp_epsilon`` > 0)
    the ladder is pre-filtered to budget-feasible points — the
    controller can then NEVER visit a point that would exhaust ε
    before the launch plan would, by construction rather than by a
    runtime guard. A pinned point that violates the budget is a
    launch error, not a silent fallback."""
    if str(getattr(cfg, "autopilot", "off")) != "on":
        return None
    band = parse_band(cfg.autopilot_band)
    keep = _budget_feasible(cfg)
    ladder = [k for k in build_ladder(cfg) if keep(k)]
    # index 0 (the launch point) is feasible by definition — its σ IS
    # the budget plan's σ
    assert ladder, "budget filter removed the launch point"
    start, pinned = 0, False
    pin = str(getattr(cfg, "autopilot_pin", "") or "")
    if pin:
        pinned = True
        pin_key = parse_key(pin)
        if not keep(pin_key):
            raise ValueError(
                f"--autopilot_pin {pin} violates the ε budget: its "
                f"noise multiplier spends --dp_epsilon "
                f"{cfg.dp_epsilon:g} faster than the launch config")
        idx = ladder_index(ladder, pin_key)
        if idx is None:
            ladder = ladder + [pin_key]
            idx = len(ladder) - 1
        start = idx
    return AutopilotController(ladder, band,
                               int(cfg.autopilot_cooldown),
                               seed=int(cfg.seed), start=start,
                               pinned=pinned)


def replay_record(record: dict) -> List[str]:
    """Re-run the recorded observation sequence through a fresh
    controller and return the per-observation key strings — bit-exact
    replay means this list equals the recorded trajectory's ``key``
    column (autopilot/replay.py asserts exactly that)."""
    ladder = [parse_key(s) for s in record["ladder"]]
    start = ladder_index(ladder, parse_key(record["initial"]))
    if record.get("pinned"):
        start = ladder_index(ladder,
                             parse_key(record["trajectory"][0]["key"])
                             if record.get("trajectory")
                             else parse_key(record["final"]))
    ctl = AutopilotController(
        ladder, tuple(record["band"]), record["cooldown"],
        seed=record.get("seed", 0), start=start or 0,
        pinned=bool(record.get("pinned")))
    keys = []
    for entry in record["trajectory"]:
        probes = {}
        if entry.get("recovery_error") is not None:
            probes["recovery_error"] = entry["recovery_error"]
        if entry.get("nan"):
            probes["agg_nan"] = 1.0
        ctl.observe(entry["round"], probes)
        keys.append(key_str(ctl.key))
    return keys


def key_of_config(cfg: Config) -> VariantKey:
    return key_of(cfg)
