"""Commit-cadence policies: DAC (paper §5.2, Algorithm 1) + evaluation baselines.

DAC regulates each producer's post-attempt waiting gap ``T`` from two explicit
budgets over the online-estimated fragile window ``tau_v`` (manifest I/O time):

  conflict budget eps:  p_conflict(T) = 1 - exp(-(N-1) tau / (T + tau)) <= eps
      =>  T >= T_conf = max(0, (N-1) tau / (-ln(1 - eps)) - tau)          (Eq. 7)
  duty budget delta:    d(T) = tau / (T + tau) <= delta
      =>  T >= T_cost = (1 - delta) / delta * tau                         (Eq. 8)

  T* = max(T_conf, T_cost); gap = T* * (1 + rho * U),  U ~ Uniform(0,1)   (Eq. 9-10)

tau_v is EMA-estimated (Eq. 6) and N is read from the committed producer state
map after each attempt — no inter-producer communication.

Baselines (paper §7.1): Naive (commit every TGB), FIXED10/FIXED100 (every K
TGBs), INCR (start 10, +1 per conflict), AIMD (TCP-style: additive increase of
commit *rate* on success, halve rate on conflict; we interpret the paper's
"interval" phrasing as rate — the classic congestion-window analogue — since a
literal reading would back off on success).
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Optional


class CommitPolicy:
    """Decides *when* a producer attempts a commit.

    ``should_attempt`` is consulted in the producer loop; ``on_outcome`` feeds
    back each attempt's result (success flag, observed fragile window, dynamic
    producer count, current time).
    """

    name = "base"

    def should_attempt(self, pending_count: int, now: float) -> bool:
        raise NotImplementedError

    def on_outcome(self, success: bool, tau_obs: float, n_producers: int,
                   now: float) -> None:
        raise NotImplementedError


class NaivePolicy(CommitPolicy):
    name = "naive"

    def should_attempt(self, pending_count, now):
        return pending_count >= 1

    def on_outcome(self, success, tau_obs, n_producers, now):
        pass


class FixedCountPolicy(CommitPolicy):
    """Commit every K produced TGBs."""

    def __init__(self, k: int):
        self.k = k
        self.name = f"fixed{k}"

    def should_attempt(self, pending_count, now):
        return pending_count >= self.k

    def on_outcome(self, success, tau_obs, n_producers, now):
        pass


class IncrPolicy(CommitPolicy):
    """Start at k=10; increase k by one on each conflict."""

    name = "incr"

    def __init__(self, k0: int = 10):
        self.k = k0

    def should_attempt(self, pending_count, now):
        return pending_count >= self.k

    def on_outcome(self, success, tau_obs, n_producers, now):
        if not success:
            self.k += 1


class AIMDPolicy(CommitPolicy):
    """TCP-style AIMD on commit rate r = 1/T: r += a on success, r /= 2 on
    conflict. Gap T = 1/r bounded to [T_min, T_max]."""

    name = "aimd"

    def __init__(self, a: float = 0.05, T0: float = 1.0,
                 T_min: float = 1e-3, T_max: float = 120.0):
        self.a = a
        self.T = T0
        self.T_min = T_min
        self.T_max = T_max
        self._last_attempt: Optional[float] = None

    def should_attempt(self, pending_count, now):
        if pending_count < 1:
            return False
        if self._last_attempt is None:
            return True
        return (now - self._last_attempt) >= self.T

    def on_outcome(self, success, tau_obs, n_producers, now):
        self._last_attempt = now
        rate = 1.0 / max(self.T, self.T_min)
        if success:
            rate += self.a
        else:
            rate *= 0.5
        self.T = min(self.T_max, max(self.T_min, 1.0 / rate))


@dataclass
class DACConfig:
    delta: float = 0.30   # duty (overhead) budget on manifest-I/O fraction
    eps: float = 0.05     # conflict budget
    alpha: float = 0.25   # EMA coefficient for tau_v
    rho: float = 0.20     # jitter magnitude
    seed: int = 0


class DACPolicy(CommitPolicy):
    """Decentralized Adaptive Commit — Algorithm 1."""

    name = "dac"

    def __init__(self, config: Optional[DACConfig] = None):
        # default must be constructed per instance: a shared `DACConfig()`
        # default argument would alias one mutable config across every policy
        config = config if config is not None else DACConfig()
        self.cfg = config
        self.tau_hat = 0.0
        self.gap = 0.0
        self.n = 1
        self._t_last: Optional[float] = None
        self._rng = random.Random(config.seed)
        # telemetry
        self.last_T_conf = 0.0
        self.last_T_cost = 0.0

    def should_attempt(self, pending_count, now):
        if pending_count < 1:
            return False
        if self._t_last is None:
            return True
        return (now - self._t_last) >= self.gap

    def on_outcome(self, success, tau_obs, n_producers, now):
        c = self.cfg
        # Eq. 6: EMA update regardless of outcome
        if self.tau_hat == 0.0:
            self.tau_hat = tau_obs
        else:
            self.tau_hat = (1 - c.alpha) * self.tau_hat + c.alpha * tau_obs
        self.n = max(1, n_producers)
        # Eq. 7-8
        denom = -math.log(1.0 - c.eps)
        self.last_T_conf = max(0.0, (self.n - 1) * self.tau_hat / denom - self.tau_hat)
        self.last_T_cost = (1.0 - c.delta) / c.delta * self.tau_hat
        t_star = max(self.last_T_conf, self.last_T_cost)  # Eq. 9
        self.gap = t_star * (1.0 + c.rho * self._rng.uniform(0.0, 1.0))  # Eq. 10
        self._t_last = now


def make_policy(name: str, **kw) -> CommitPolicy:
    name = name.lower()
    if name == "dac":
        cfg_kw = {k: v for k, v in kw.items() if k in DACConfig.__dataclass_fields__}
        return DACPolicy(DACConfig(**cfg_kw))
    if name == "naive":
        return NaivePolicy()
    if name in ("fixed10", "fixed100"):
        return FixedCountPolicy(int(name[len("fixed"):]))
    if name == "fixed":
        return FixedCountPolicy(int(kw.get("k", 10)))
    if name == "incr":
        return IncrPolicy(int(kw.get("k0", 10)))
    if name == "aimd":
        return AIMDPolicy(**{k: v for k, v in kw.items() if k in ("a", "T0", "T_min", "T_max")})
    raise ValueError(f"unknown commit policy {name!r}")


# ---------------------------------------------------------------------------
# DAC shard extension: "which shard to commit to" (ROADMAP item 4)
# ---------------------------------------------------------------------------

class ShardChooser:
    """Extends DAC from *when* to commit to *which shard chain* to commit to.

    Default placement is hash-by-producer (deterministic, coordination-free).
    The chooser then tracks an EMA of this producer's own conflict outcomes —
    the same observation stream DAC's cadence uses — and, when the home shard
    looks persistently hot (EMA above ``conflict_threshold``) and the cooldown
    has elapsed, proposes a move to the least-loaded shard as measured by the
    per-shard active-producer counts read from storage. All signals are
    observed through the manifest chains; producers never talk to each other
    (paper §5 invariant, extended).

    Hysteresis matters: switching costs a cross-shard offset re-derivation
    and briefly concentrates contention on the target, so the cooldown and a
    strict-improvement requirement keep the pool from oscillating.
    """

    def __init__(self, n_shards: int, producer_id: str,
                 conflict_threshold: float = 0.5, alpha: float = 0.25,
                 cooldown: int = 16):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = n_shards
        self.producer_id = producer_id
        self.conflict_threshold = conflict_threshold
        self.alpha = alpha
        self.cooldown = cooldown
        # zlib.crc32, not hash(): stable across processes and interpreter runs
        import zlib
        self.shard = zlib.crc32(producer_id.encode("utf-8")) % n_shards
        self.conflict_ema = 0.0
        self._since_move = 0
        self._since_probe = 0

    def observe(self, success: bool) -> None:
        """Feed one commit outcome on the current home shard."""
        x = 0.0 if success else 1.0
        self.conflict_ema += self.alpha * (x - self.conflict_ema)
        self._since_move += 1
        self._since_probe += 1

    def should_probe(self) -> bool:
        """Worth paying the K-shard load read to consider moving? The probe
        cooldown matters as much as the move cooldown: a persistently-hot
        pool would otherwise re-pay the K refreshes on *every* conflict once
        the EMA crosses the threshold."""
        return (self.n_shards > 1
                and self.conflict_ema > self.conflict_threshold
                and self._since_move >= self.cooldown
                and self._since_probe >= self.cooldown)

    def choose(self, shard_loads) -> int:
        """Pick the target shard given per-shard active-producer counts.
        Returns the current shard unless a strictly less-loaded one exists;
        ties among candidates break by lowest index (deterministic)."""
        self._since_probe = 0
        loads = list(shard_loads)
        if len(loads) != self.n_shards:
            raise ValueError(f"expected {self.n_shards} loads, got {len(loads)}")
        best = min(range(self.n_shards), key=lambda k: (loads[k], k))
        # +1: moving there adds us to the target's pool
        if loads[best] + 1 < loads[self.shard]:
            return best
        return self.shard

    def move_to(self, shard: int) -> None:
        self.shard = shard
        self.conflict_ema = 0.0
        self._since_move = 0
        self._since_probe = 0
