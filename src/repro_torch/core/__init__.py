"""The OptSVA-CF transactional memory that the training state store
(``repro_torch.txstore``) runs on: line-for-line copies of the plain-Python
modules of ``repro.core`` that it needs (the port imports nothing of
``repro``). ``sva``, ``tfa`` and ``locks`` (the baselines) are not copied,
and ``Registry.connect`` (the TCP transport, ``repro.net``) raises.

Public surface::

    from repro_torch.core import (
        Mode, access, Suprema, Registry, Transaction,
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
from .registry import Node, Registry, SharedObject
from .transaction import CommuteAccess, ObjectAccess, Transaction, TxProxy
from .versioning import VersionHeader, dispense_versions

__all__ = [
    "INF", "AbortError", "IllegalState", "Mode", "OpStats",
    "RemoteObjectFailure", "RetrySignal", "Suprema", "SupremumViolation",
    "TransactionError", "access", "CopyBuffer", "LogBuffer", "StateHolder",
    "Executor", "Task", "TransactionMonitor", "Node", "Registry",
    "SharedObject", "CommuteAccess", "ObjectAccess", "Transaction", "TxProxy",
    "VersionHeader", "dispense_versions",
]
