"""The device's idle share over the serving stretch (one prefill, its merge
and the decode steps after it): 1 - the union of its kernels' and copies'
intervals over the stretch's wall time, in %."""


def read(record):
    st = record.get("stretch")
    if record.get("kind") != "serve" or not st or not st["busy_s"]:
        return None
    return (1 - st["busy_s"] / st["window_s"]) * 100
