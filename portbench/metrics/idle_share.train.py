"""The device's idle share over the training stretch (whole Trainer steps:
data, the step, the loss's read, the commit): 1 - the union of its
kernels' and copies' intervals over the stretch's wall time, in %."""


def read(record):
    st = record.get("stretch")
    if record.get("kind") != "train" or not st or not st["busy_s"]:
        return None
    return (1 - st["busy_s"] / st["window_s"]) * 100
