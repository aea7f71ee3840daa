"""Host ms of a Server decode step outside its token read: the step's
``timing["decode_s"]`` less ``timing["decode_read_s"]`` (the seconds the
host sat blocked in the step's ``tolist()``), over the decode steps in the
window: the host issuing the step's work (the profiler's own seconds left
out)."""


def read(record):
    n = record.get("stats", {}).get("steps")
    timing = record.get("timing", {})
    if (record.get("kind") != "serve" or not n
            or "decode_read_s" not in timing):
        return None
    return (timing["decode_s"] - timing["decode_read_s"]) / n * 1e3
