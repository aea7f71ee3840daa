"""Device busy ms of a training step: the union of the device's kernels and
copies over the profiled steps, over their number."""


def read(record):
    st = record.get("stretch")
    if record.get("kind") != "train" or not st or not st["busy_s"]:
        return None
    return st["busy_s"] / st["steps"] * 1e3
