"""Rényi-DP accountant for the subsampled Gaussian mechanism.

A copy of ``commefficient_tpu/privacy/accountant.py``: pure host
math, imports no torch. The accountant composes one RDP curve per
round and converts to (ε, δ) on demand.

Per round the mechanism (privacy/mechanism.py) releases the
aggregated sketch table + N(0, (σ·Δ)²) where Δ bounds one client's
contribution and σ = ``--dp_noise_mult``. When a round's cohort is
genuinely Poisson-sampled at rate q (every client tossed
independently), the round is the sampled Gaussian mechanism; its RDP
at integer order α is the exact Mironov–Talwar–Zhang closed form

    ε_α = log( Σ_{k=0}^{α} C(α,k) (1-q)^{α-k} q^k
               · exp(k(k-1)/(2σ²)) ) / (α-1)

(q=1 degenerates to the plain Gaussian α/(2σ²)). RDP composes by
addition over rounds; ε(δ) is the order-minimised conversion

    ε = min_α  ε_α_total + log((α-1)/α) − (log δ + log α)/(α-1)

(the tightened Canonne–Kamath–Steinke bound). The repo's own runs
charge q = 1 — NO subsampling amplification: the FedSampler cohort
is ``num_workers`` non-exhausted clients drawn without replacement,
and every client participates in ~data_i/batch rounds per epoch
until its data is spent, so participation is neither Poisson nor
independent across rounds and the amplified curve would under-report
ε (``sample_rate_of``). The subsampled closed form stays available
for callers that do Poisson-sample. Two round features and what they
are charged:

- **staleness weights** (asyncfed) earn a sensitivity discount
  because DP folds normalise by the STATIC padded capacity W·B
  (core/rounds.py), never by the weighted datapoint total: a
  client's released contribution is cw_i·t_i/(W·B), genuinely
  scaled by its fold weight, so a round whose largest alive weight
  is w has sensitivity w·Δ and is charged ``step(weight_scale=w)``
  — the effective noise multiplier σ/w (runtime/fed_model.py).
  The discount is sound ONLY against a weight-independent
  normaliser; against the weight-preserving Σ cw_i·n_i denominator
  uniform weights would cancel out of the release and the
  discounted curve would under-report ε.
- **quantization**: the int8/fp8 wire qdq runs *after* the noise
  (core/rounds.py ordering) — post-processing, charged nothing.

State (per-order RDP totals + step count) is a flat JSON dict of
Python floats, so its round trip is bit-exact.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

# integer orders: dense low range where the minimum usually lands,
# sparse tail for tiny-q / huge-σ regimes
DEFAULT_ORDERS = tuple(range(2, 64)) + (72, 96, 128, 192, 256, 512)


def _log_comb(n: int, k: int) -> float:
    return (math.lgamma(n + 1) - math.lgamma(k + 1)
            - math.lgamma(n - k + 1))


def rdp_gaussian(sigma: float, alpha: int) -> float:
    """RDP of the (unsampled) Gaussian mechanism at order alpha."""
    return float(alpha) / (2.0 * sigma * sigma)


def rdp_subsampled_gaussian(q: float, sigma: float,
                            alpha: int) -> float:
    """RDP at integer order alpha ≥ 2 of the Poisson-sampled Gaussian
    with sampling rate q and noise multiplier sigma."""
    assert alpha >= 2 and alpha == int(alpha), alpha
    if sigma <= 0.0:
        return math.inf
    if q <= 0.0:
        return 0.0
    if q >= 1.0:
        return rdp_gaussian(sigma, alpha)
    # log-sum-exp over the binomial expansion
    log_terms = []
    for k in range(alpha + 1):
        lt = (_log_comb(alpha, k)
              + (alpha - k) * math.log1p(-q)
              + (k * math.log(q) if k else 0.0)
              + k * (k - 1) / (2.0 * sigma * sigma))
        log_terms.append(lt)
    m = max(log_terms)
    return (m + math.log(sum(math.exp(t - m) for t in log_terms))) \
        / (alpha - 1)


def eps_from_rdp(orders: Sequence[int], rdp: Sequence[float],
                 delta: float) -> float:
    """Order-minimised RDP → (ε, δ) conversion (CKS tightening).
    Returns inf when every order is inf (σ = 0)."""
    assert 0.0 < delta < 1.0, delta
    best = math.inf
    for alpha, r in zip(orders, rdp):
        if not math.isfinite(r):
            continue
        eps = (r + math.log((alpha - 1) / alpha)
               - (math.log(delta) + math.log(alpha)) / (alpha - 1))
        best = min(best, max(eps, 0.0))
    return best


class PrivacyAccountant:
    """Composes per-round RDP; converts to ε(δ) on demand.

    One instance per run. ``step()`` after every released round;
    ``epsilon()`` is the spent budget so far; ``state_dict`` /
    ``load_state`` round-trip bit-exactly through JSON.
    """

    def __init__(self, noise_multiplier: float, sample_rate: float,
                 delta: float,
                 orders: Sequence[int] = DEFAULT_ORDERS):
        assert noise_multiplier >= 0.0, noise_multiplier
        assert 0.0 <= sample_rate <= 1.0, sample_rate
        assert 0.0 < delta < 1.0, delta
        self.noise_multiplier = float(noise_multiplier)
        self.sample_rate = float(sample_rate)
        self.delta = float(delta)
        self.orders = tuple(int(a) for a in orders)
        self._rdp = [0.0] * len(self.orders)
        self.steps = 0

    # ------------------------------------------------------------ #

    def round_rdp(self, weight_scale: float = 1.0,
                  sigma: Optional[float] = None) -> list:
        """One round's RDP curve. ``weight_scale=w`` charges the
        effective noise multiplier σ/w — sound ONLY for a mechanism
        that scales every client's contribution by ≤ w against a
        weight-independent normaliser. The shipped DP folds qualify:
        they divide by the static W·B capacity, so the runtime
        charges the round's largest alive staleness weight (module
        docstring). ``sigma`` overrides the base noise
        multiplier for the round — the autopilot's active variant may
        run a different ``dp_noise_mult`` than the launch config
        (geometry moves rescale it; autopilot/lattice.py)."""
        assert 0.0 < weight_scale <= 1.0, weight_scale
        base = self.noise_multiplier if sigma is None else float(sigma)
        eff = base / weight_scale if base > 0 else 0.0
        return [rdp_subsampled_gaussian(self.sample_rate, eff, a)
                for a in self.orders]

    def step(self, weight_scale: float = 1.0,
             sigma: Optional[float] = None) -> None:
        """Charge one released round."""
        for i, r in enumerate(self.round_rdp(weight_scale, sigma)):
            self._rdp[i] += r
        self.steps += 1

    def epsilon(self, delta: Optional[float] = None) -> float:
        """ε spent so far at the accountant's δ (or an override)."""
        if self.steps == 0:
            return 0.0
        return eps_from_rdp(self.orders, self._rdp,
                            self.delta if delta is None else delta)

    def epsilon_after(self, extra_steps: int,
                      weight_scale: float = 1.0,
                      sigma: Optional[float] = None) -> float:
        """Projected ε after ``extra_steps`` more rounds at the given
        weight scale (and optional per-round σ override) — the
        autopilot's budget-feasibility check and the alarm's
        predicted-exhaustion round, without mutating state."""
        if extra_steps <= 0:
            return self.epsilon()
        per = self.round_rdp(weight_scale, sigma)
        total = [a + extra_steps * b for a, b in zip(self._rdp, per)]
        return eps_from_rdp(self.orders, total, self.delta)

    def rounds_left(self, eps_budget: float,
                    weight_scale: float = 1.0,
                    sigma: Optional[float] = None,
                    max_steps: int = 1 << 20) -> int:
        """How many MORE rounds fit under ``eps_budget`` from the
        current spent state — bisection on ``epsilon_after`` (ε is
        monotone in the step count). 0 when the budget is already
        spent; ``max_steps`` when it is never reached inside it."""
        assert eps_budget > 0.0, eps_budget
        if self.epsilon() >= eps_budget:
            return 0
        if self.epsilon_after(max_steps, weight_scale,
                              sigma) <= eps_budget:
            return max_steps
        lo, hi = 0, max_steps  # eps_after(lo) < budget < eps_after(hi)
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if self.epsilon_after(mid, weight_scale,
                                  sigma) <= eps_budget:
                lo = mid
            else:
                hi = mid
        return lo

    # ------------------------------------------------------------ #

    def state_dict(self) -> dict:
        """JSON-exact state: floats round-trip bit-for-bit."""
        return {
            "noise_multiplier": self.noise_multiplier,
            "sample_rate": self.sample_rate,
            "delta": self.delta,
            "orders": list(self.orders),
            "rdp": list(self._rdp),
            "steps": int(self.steps),
        }

    @classmethod
    def load_state(cls, state: dict) -> "PrivacyAccountant":
        acc = cls(state["noise_multiplier"], state["sample_rate"],
                  state["delta"], orders=state["orders"])
        rdp = [float(x) for x in state["rdp"]]
        assert len(rdp) == len(acc.orders), (len(rdp), len(acc.orders))
        acc._rdp = rdp
        acc.steps = int(state["steps"])
        return acc


def steps_to_budget(noise_multiplier: float, sample_rate: float,
                    delta: float, eps_budget: float,
                    max_steps: int = 1 << 20,
                    orders: Sequence[int] = DEFAULT_ORDERS) -> int:
    """How many rounds fit inside ``eps_budget``? Exact bisection on
    the composed curve (ε is monotone in the step count). 0 when even
    one round exceeds the budget; ``max_steps`` when the budget is
    never reached inside it (σ large / q tiny)."""
    assert eps_budget > 0.0, eps_budget
    per = [rdp_subsampled_gaussian(sample_rate, noise_multiplier, a)
           for a in orders]

    def eps_at(n):
        return eps_from_rdp(orders, [n * r for r in per], delta)

    if eps_at(1) > eps_budget:
        return 0
    if eps_at(max_steps) <= eps_budget:
        return max_steps
    lo, hi = 1, max_steps  # eps_at(lo) <= budget < eps_at(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if eps_at(mid) <= eps_budget:
            lo = mid
        else:
            hi = mid
    return lo


def sample_rate_of(cfg) -> float:
    """The accountant's per-round sampling rate for this config:
    1.0 — NO subsampling amplification. Poisson amplification needs
    every client tossed independently at rate q each round; the
    FedSampler cohort is ``num_workers`` non-exhausted clients drawn
    WITHOUT replacement, with every client participating until its
    epoch data is spent, so charging q = num_workers/num_clients
    would under-report ε (module docstring). The subsampled curve
    stays available to callers that genuinely Poisson-sample
    (``rdp_subsampled_gaussian`` / ``PrivacyAccountant(sample_rate=
    q)``). Shared by the accountant, the autopilot's budget
    pre-filter and the selftest's closed-form check so all three
    price the same mechanism."""
    del cfg
    return 1.0


def build_accountant(cfg) -> Optional[PrivacyAccountant]:
    """The run's accountant, or None when ``--dp off``."""
    if str(getattr(cfg, "dp", "off")) == "off":
        return None
    return PrivacyAccountant(float(cfg.dp_noise_mult),
                             sample_rate_of(cfg),
                             float(cfg.dp_delta))
