"""Demo shared-object classes for the distributed examples and tests.

Objects bound over the wire are pickled *by reference* (class path), so the
node server must be able to import their class. Classes defined in a
``__main__`` script can't be imported remotely — the distributed quickstart
and transport tests use these instead.
"""
from __future__ import annotations

import time

from repro_torch.core import Mode, access


class Account:
    """The paper's bank account (Fig. 7), with declared access modes."""

    def __init__(self, balance: int = 0):
        self.bal = balance

    @access(Mode.READ)
    def balance(self) -> int:
        return self.bal

    @access(Mode.UPDATE)
    def deposit(self, v: int) -> None:
        self.bal += v

    @access(Mode.UPDATE)
    def withdraw(self, v: int) -> None:
        self.bal -= v

    @access(Mode.WRITE)
    def reset(self) -> None:
        self.bal = 0

    def __tx_snapshot__(self) -> "Account":
        return Account(self.bal)


class GuardedAccount(Account):
    """Account whose withdrawals enforce a non-negative balance — gives
    transport tests a method that *raises* mid-transaction (e.g. in the
    middle of a fused ``txn_call_batch``)."""

    @access(Mode.UPDATE)
    def withdraw(self, v: int) -> int:
        if v > self.bal:
            raise ValueError(f"insufficient funds: {v} > {self.bal}")
        self.bal -= v
        return self.bal

    def __tx_snapshot__(self) -> "GuardedAccount":
        return GuardedAccount(self.bal)


class LedgerAccount(Account):
    """Account that also keeps an append-only mark ledger.

    ``mark`` is a pure WRITE (no read of state): a write-only transaction
    on it takes the §2.8.4 path — client-side log buffering, one-way
    ``lw_apply`` kickoff, asynchronous apply+release on the home node.
    The seed-sweep fuzzer uses unique per-transaction tags to check the
    exactly-once invariant: a committed mark appears exactly once, an
    aborted or crashed one never (no lost writes, no double applies, no
    dead transaction's log applied)."""

    def __init__(self, balance: int = 0):
        super().__init__(balance)
        self.marks = []

    @access(Mode.WRITE)
    def mark(self, tag) -> None:
        self.marks.append(tag)

    @access(Mode.READ)
    def read_marks(self):
        return list(self.marks)

    def __tx_snapshot__(self) -> "LedgerAccount":
        c = LedgerAccount(self.bal)
        c.marks = list(self.marks)
        return c


class HotAccount(Account):
    """Account whose deposits form a commuting method class (DESIGN.md §12).

    ``deposit`` invocations from commute-restricted transactions skip
    version-gated dispensing and merge as deltas at the home node; exact
    accesses (``balance``, ``withdraw``) snap the object back to full
    OptSVA ordering."""

    @access(Mode.WRITE, commutes="deposit")
    def deposit(self, v: int) -> None:
        self.bal += v

    def __tx_snapshot__(self) -> "HotAccount":
        return HotAccount(self.bal)


class HotLedgerAccount(LedgerAccount):
    """LedgerAccount whose deposits form a commuting method class (§12).

    The seed-sweep fuzzer's commute mode binds these: commute-restricted
    transfers ship both deposit legs as mergeable deltas (one positive,
    one negative — the sum is conserved even when the deltas fold under
    the merge lock), while marks, audits, and exact transfers keep the
    full version-gated path and force snap-backs mid-sweep."""

    @access(Mode.WRITE, commutes="deposit")
    def deposit(self, v: int) -> None:
        self.bal += v

    def __tx_snapshot__(self) -> "HotLedgerAccount":
        c = HotLedgerAccount(self.bal)
        c.marks = list(self.marks)
        return c


class SlowAccount(Account):
    """Account whose operations take ``op_time`` seconds at the home node —
    makes CF delegation visible in timings."""

    def __init__(self, balance: int = 0, op_time: float = 0.0):
        super().__init__(balance)
        self.op_time = op_time

    @access(Mode.READ)
    def balance(self) -> int:
        if self.op_time:
            time.sleep(self.op_time)
        return self.bal

    def __tx_snapshot__(self) -> "SlowAccount":
        return SlowAccount(self.bal, self.op_time)
