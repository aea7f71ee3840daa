"""OptSVA-CF pessimistic distributed transactional memory (the paper's core).

Public surface::

    from repro_torch.core import (
        Mode, access, Suprema, Registry, Transaction,
        SvaTransaction, LockTransaction, TfaTransaction,
        AbortError, RetrySignal, TransactionMonitor,
    )
"""
from .api import (
    INF, AbortError, IllegalState, Mode, OpStats, RemoteObjectFailure,
    RetrySignal, Suprema, SupremumViolation, TransactionError, access,
)
from .buffers import CopyBuffer, LogBuffer, StateHolder
from .executor import Executor, Task
from .faults import TransactionMonitor
from .locks import GLOBAL_LOCK, LockTransaction, RWLock
from .registry import Node, Registry, SharedObject
from .sva import SvaTransaction
from .tfa import TfaTransaction
from .transaction import CommuteAccess, ObjectAccess, Transaction, TxProxy
from .versioning import VersionHeader, dispense_versions

__all__ = [
    "INF", "AbortError", "IllegalState", "Mode", "OpStats",
    "RemoteObjectFailure", "RetrySignal", "Suprema", "SupremumViolation",
    "TransactionError", "access", "CopyBuffer", "LogBuffer", "StateHolder",
    "Executor", "Task", "TransactionMonitor", "GLOBAL_LOCK",
    "LockTransaction", "RWLock", "Node", "Registry", "SharedObject",
    "SvaTransaction", "TfaTransaction", "CommuteAccess", "ObjectAccess",
    "Transaction", "TxProxy", "VersionHeader", "dispense_versions",
]
