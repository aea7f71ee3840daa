from .store import StateCell, TornSnapshotError, VersionedStateStore
__all__ = ["StateCell", "TornSnapshotError", "VersionedStateStore"]
