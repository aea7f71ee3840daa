"""Host ms a training step spends outside its step function and loss read:
the window's seconds over its steps, less the mean of the Trainer's own
``metrics_log`` ``dt`` (which covers the step and the loss's read): the
data, its upload, the transactional commit and the bookkeeping."""


def read(record):
    if record.get("kind") != "train" or not record.get("dt"):
        return None
    per_step = (record["window_s"] - record["profiler_s"]) / record["steps"]
    return (per_step - sum(record["dt"]) / len(record["dt"])) * 1e3
