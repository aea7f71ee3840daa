"""Host ms of a Server decode step: its ``timing["decode_s"]`` over the decode
steps in the window (the step, the argmax and the tokens' read to the host;
the profiler's own seconds left out)."""


def read(record):
    n = record.get("stats", {}).get("steps")
    if record.get("kind") != "serve" or not n:
        return None
    return record["timing"]["decode_s"] / n * 1e3
