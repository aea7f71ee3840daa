"""Host ms a request's prefill takes in the Server: its ``timing["prefill_s"]``
over the requests admitted in the window (the prefill, the first token's
read and the merge into the slot; the profiler's own seconds left out)."""


def read(record):
    n = record.get("stats", {}).get("admitted")
    if record.get("kind") != "serve" or not n:
        return None
    return record["timing"]["prefill_s"] / n * 1e3
