"""The window drivers, one per entry kind (``serve``, ``train``). Each has
``setup(cell, seed, device)``, ``window(ctx, seconds, trace)`` and
``check(ctx)``; ``run`` chains them. The harness picks the driver by the
cell's ``kind``."""
