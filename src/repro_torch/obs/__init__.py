"""Copies of ``repro.obs.txtrace`` and ``repro.obs.metrics``, which the
copied OptSVA-CF core (``repro_torch.core``) instruments itself with. Both
are plain Python; the port keeps its own copies because it imports nothing
of ``repro``. Tracing is off unless ``txtrace.enabled`` is set (or the
``REPRO_TRACE`` environment variable)."""
from . import metrics, txtrace  # noqa: F401

__all__ = ["txtrace", "metrics"]
