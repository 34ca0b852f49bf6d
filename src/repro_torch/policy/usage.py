"""The decayed TRES usage ledger: one shared accounting of who consumed
what, across every execution engine.

:class:`FairShareTree` extends the association tree with a usage ledger:
every finished (or preempted) batch-job segment charges its account
``elapsed × TRES-cost``, and every served token / KV-cache-second charges
the same ledger through :meth:`FairShareTree.charge_tres` — so a single
``sshare`` call reports batch *and* serving consumption against one set
of shares.  The cost weights accelerator-seconds far above CPU/mem
(``TRESBillingWeights``).  Usage decays with an exponential half-life
(``PriorityDecayHalfLife``), so yesterday's hog is not punished forever.
Charges propagate to all ancestors.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

from repro_torch.policy.accounts import Account, AccountTree
from repro_torch.policy.qos import job_tres

#: TRESBillingWeights — accelerator-seconds dominate the charge.
DEFAULT_TRES_WEIGHTS = {
    "gres/tpu": 1.0,
    "gres/gpu": 1.0,
    "cpu": 0.04,
    "mem": 1e-5,          # per MB-second
}


class FairShareTree(AccountTree):
    """Account hierarchy + decayed TRES usage ledger."""

    def __init__(self, half_life_s: float = 7 * 86_400.0,
                 tres_weights: Optional[dict] = None):
        assert half_life_s > 0
        super().__init__()
        self.half_life_s = half_life_s
        self.tres_weights = dict(tres_weights or DEFAULT_TRES_WEIGHTS)
        self.usage: dict[str, float] = {"root": 0.0}
        # per-TRES-key raw consumption (same decay as ``usage``): what a
        # tenant actually burned, before billing weights — e.g.
        # ``gres/kv_page`` here is true HBM page-steps held, which is how
        # ``sshare --tres`` reports paged-cache residency per tenant
        self.tres_usage: dict[str, dict[str, float]] = {}
        self._last_decay: float = 0.0
        self._clock: Optional[Callable[[], float]] = None

    # ------------------------------------------------------------- admin ----
    def add_account(self, name: str, parent: str = "root",
                    shares: int = 1, description: str = "") -> Account:
        acct = super().add_account(name, parent=parent, shares=shares,
                                   description=description)
        self.usage.setdefault(name, 0.0)
        return acct

    # ------------------------------------------------------------- usage ----
    def enable_wallclock_decay(self, clock: Callable[[], float]
                               = time.monotonic):
        """Drive decay from a wall clock instead of an engine event loop.

        For long-lived pure-serving deployments: nothing there calls
        ``decay_to``, so without this an old hog's usage never decays and
        it is punished forever.  The ledger's decay epoch is re-anchored
        to ``clock()`` now (usage accrued so far starts decaying from
        this instant); afterwards every :meth:`tick` advances decay to
        the current clock reading.  Do NOT enable on a ledger whose decay
        is already driven by a simulated cluster clock — the two
        timebases would mix.
        """
        self._clock = clock
        self._last_decay = float(clock())

    def tick(self):
        """Advance decay to the wall clock, if enabled (no-op otherwise)."""
        if self._clock is not None:
            self.decay_to(self._clock())

    def decay_to(self, now: float):
        """Apply exponential half-life decay up to ``now``."""
        dt = now - self._last_decay
        if dt <= 0:
            return
        factor = 2.0 ** (-dt / self.half_life_s)
        for name in self.usage:
            self.usage[name] *= factor
        for per_key in self.tres_usage.values():
            for key in per_key:
                per_key[key] *= factor
        self._last_decay = now

    def tres_cost_per_s(self, req) -> float:
        """Billing rate of one job-second for this resource request."""
        cost = 0.0
        for key, amount in job_tres(req).items():
            cost += self.tres_weights.get(key, 0.0) * amount
        return cost

    def charge_tres(self, account: str, tres: dict,
                    now: Optional[float] = None,
                    usage_factor: float = 1.0) -> float:
        """Charge a raw TRES vector to the account chain.

        The engine-agnostic charging entry: batch charges job-seconds
        through :meth:`charge`; serving charges generated tokens and
        KV-cache residency here directly.  ``now=None`` charges at the
        ledger's current decay epoch (no decay advance) — right for
        engines without their own clock sharing a ledger whose decay is
        driven elsewhere.  Returns the charged amount (weighted
        TRES units).
        """
        if account not in self.accounts:        # auto-associate unknowns
            self.add_account(account)
        if now is not None:
            self.decay_to(now)
        amount = sum(self.tres_weights.get(key, 0.0) * amt
                     for key, amt in tres.items()) * usage_factor
        for acct in self._ancestors(account):
            self.usage[acct.name] = self.usage.get(acct.name, 0.0) + amount
            per_key = self.tres_usage.setdefault(acct.name, {})
            for key, amt in tres.items():
                if amt:
                    # raw, UNdiscounted: usage_factor is a billing break,
                    # not a consumption reduction — an auditor reading
                    # sshare --tres must see what was actually held
                    per_key[key] = per_key.get(key, 0.0) + amt
        return amount

    def tres_usage_of(self, account: str) -> dict:
        """Decayed raw per-key TRES consumption of one account."""
        return dict(self.tres_usage.get(account, {}))

    def charge(self, account: str, req, elapsed_s: float, now: float,
               usage_factor: float = 1.0) -> float:
        """Charge ``elapsed_s`` of the request's TRES to the account chain.

        Returns the charged amount (weighted TRES-seconds).
        """
        elapsed = max(elapsed_s, 0.0)
        return self.charge_tres(
            account, {k: v * elapsed for k, v in job_tres(req).items()},
            now=now, usage_factor=usage_factor)

    # ----------------------------------------------------------- factors ----
    def norm_usage(self, name: str) -> float:
        total = self.usage.get("root", 0.0)
        if total <= 0:
            return 0.0
        return self.usage.get(name, 0.0) / total

    def fair_share_factor(self, account: str) -> float:
        """The classic SLURM ``2^(-usage/shares)`` in [0, 1]."""
        if account not in self.accounts:
            return 1.0                          # never-seen account: fresh
        shares = self.norm_shares(account)
        if shares <= 0:
            return 0.0
        return 2.0 ** (-self.norm_usage(account) / shares)

    # ---------------------------------------------------------- snapshot ----
    def snapshot(self) -> dict:
        return {
            "half_life_s": self.half_life_s,
            "tres_weights": dict(self.tres_weights),
            "accounts": [(a.name, a.parent, a.shares, a.description)
                         for a in self.accounts.values()],
            "user_account": dict(self.user_account),
            "usage": dict(self.usage),
            "tres_usage": {k: dict(v) for k, v in self.tres_usage.items()},
            "last_decay": self._last_decay,
        }

    @classmethod
    def restore(cls, snap: dict) -> "FairShareTree":
        t = cls(half_life_s=snap["half_life_s"],
                tres_weights=snap["tres_weights"])
        for name, parent, shares, desc in snap["accounts"]:
            if name == "root":
                continue
            t.accounts[name] = Account(name, parent=parent, shares=shares,
                                       description=desc)
        t.user_account = dict(snap["user_account"])
        t.usage = dict(snap["usage"])
        t.tres_usage = {k: dict(v)
                        for k, v in snap.get("tres_usage", {}).items()}
        t._last_decay = snap["last_decay"]
        return t
