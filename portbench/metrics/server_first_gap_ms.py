"""Mean ms a served request waits from its first token to its second, by
the Server's own clock: ``timing["first_gap_s"]`` (from the host's read of
a request's first token, at the end of its prefill, to its read of the
second, at the end of the next decode step; summed over requests) over the
window's requests that got two tokens or more (``record["served"]``). At a
wave's admission that is the wait behind the wave's later prefills."""


def read(record):
    if record.get("kind") != "serve":
        return None
    seconds = record.get("timing", {}).get("first_gap_s")
    n = sum(1 for _, tokens in record.get("served", ()) if tokens >= 2)
    if seconds is None or not n:
        return None
    return seconds / n * 1e3
