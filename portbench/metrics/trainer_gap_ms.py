"""Median host ms of a training step in ``Trainer.run`` outside the step
function's call and the loss and ``grad_norm`` reads: the Trainer's own
``gap_us`` histogram in ``repro_torch.obs.metrics.registry("train")``
(the data, the commit, the bookkeeping; with the pipeline's set-up and the
checkpointer's drain, since each step is a call of its own here), over
every step the process ran."""


def read(record):
    if record.get("kind") != "train":
        return None
    from repro_torch.obs import metrics
    h = metrics.registry("train").snapshot()["histograms"].get("gap_us")
    if not h or not h["count"]:
        return None
    return h["p50_us"] / 1e3
