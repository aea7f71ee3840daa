"""Host ms of the transactional commit of a training step: the
``VersionedStateStore.commit_step`` ranges of the profiled stretch, over
their number (the OptSVA-CF write transaction over params, opt and the
data cursor)."""


def read(record):
    st = record.get("stretch") or {}
    n = st.get("range_calls", {}).get("VersionedStateStore.commit_step")
    if record.get("kind") != "train" or not n:
        return None
    return st["range_host_s"]["VersionedStateStore.commit_step"] / n * 1e3
