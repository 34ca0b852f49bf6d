"""The sacctmgr association tree: accounts, raw shares, user bindings.

A hierarchy of accounts (``root`` → org → team) with raw *shares*; users
associate to exactly one account.  Normalized shares are computed
sibling-relative and multiplied down the tree, exactly like ``sshare``'s
NormShares column.

Pure structure — no usage, no clocks.  The decayed TRES ledger that turns
this tree into a fair-share engine lives in :mod:`repro_torch.policy.usage`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class Account:
    """One node of the sacctmgr association tree."""
    name: str
    parent: Optional[str] = "root"      # None only for root itself
    shares: int = 1
    description: str = ""


class AccountTree:
    """Account hierarchy + user associations (the ``sacctmgr`` surface)."""

    def __init__(self):
        self.accounts: dict[str, Account] = {
            "root": Account("root", parent=None, shares=1)}
        self.user_account: dict[str, str] = {}

    # ------------------------------------------------------------- admin ----
    def add_account(self, name: str, parent: str = "root",
                    shares: int = 1, description: str = "") -> Account:
        """``sacctmgr add account <name> parent=<p> fairshare=<shares>``."""
        assert name not in self.accounts, f"account {name!r} exists"
        assert parent in self.accounts, f"unknown parent {parent!r}"
        assert shares >= 1
        acct = Account(name, parent=parent, shares=shares,
                       description=description)
        self.accounts[name] = acct
        return acct

    def add_user(self, user: str, account: str):
        """``sacctmgr add user <u> account=<a>`` (one association/user)."""
        assert account in self.accounts, f"unknown account {account!r}"
        self.user_account[user] = account

    def add_user_association(self, user: str, account: str,
                             shares: int = 1) -> Account:
        """Two-level ``tenant/user`` association (idempotent): a leaf
        account named ``<account>/<user>`` parented under ``account``,
        with the user bound to it.  Charges landed on the leaf propagate
        to the tenant and root like any other subtree, so sibling users
        fair-share *within* their tenant's slice and ``sshare`` renders
        the nesting with no special casing."""
        assert account in self.accounts, f"unknown account {account!r}"
        leaf = f"{account}/{user}"
        acct = self.accounts.get(leaf)
        if acct is None:
            acct = self.add_account(leaf, parent=account, shares=shares)
        self.user_account.setdefault(user, leaf)
        return acct

    def modify_account(self, name: str, shares: Optional[int] = None,
                       parent: Optional[str] = None,
                       description: Optional[str] = None) -> Account:
        """``sacctmgr modify account <name> set fairshare=<n> [parent=<p>]``
        on a live tree.  Normalized shares are computed on read, so every
        priority/sshare pass after this sees the new values — no restart,
        exactly like SLURM's live association edits.  Reparenting refuses
        cycles (an account may not move under its own subtree)."""
        assert name in self.accounts, f"unknown account {name!r}"
        assert name != "root", "cannot modify the root association"
        acct = self.accounts[name]
        if shares is not None:
            assert shares >= 1, shares
            acct.shares = shares
        if parent is not None:
            assert parent in self.accounts, f"unknown parent {parent!r}"
            ancestor = parent
            while ancestor is not None:
                assert ancestor != name, \
                    f"reparenting {name!r} under its own subtree"
                ancestor = self.accounts[ancestor].parent
            acct.parent = parent
        if description is not None:
            acct.description = description
        return acct

    def account_of(self, user: str, default: str = "root") -> str:
        return self.user_account.get(user, default)

    def children(self, name: str) -> list[Account]:
        return [a for a in self.accounts.values() if a.parent == name]

    def _ancestors(self, name: str):
        """name, parent, ..., root."""
        while name is not None:
            acct = self.accounts[name]
            yield acct
            name = acct.parent

    # ----------------------------------------------------------- factors ----
    def norm_shares(self, name: str) -> float:
        """Sibling-relative shares multiplied down from root (sshare col)."""
        assert name in self.accounts, f"unknown account {name!r}"
        frac = 1.0
        for acct in self._ancestors(name):
            if acct.parent is None:
                break
            level = sum(a.shares for a in self.children(acct.parent))
            frac *= acct.shares / max(level, 1)
        return frac
