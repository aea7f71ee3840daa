"""Median host ms a training step spends on its data: the Trainer's own
``data_us`` histogram in ``repro_torch.obs.metrics.registry("train")``
(the pipeline's ``next`` and the batch's placement), over every step the
process ran."""


def read(record):
    if record.get("kind") != "train":
        return None
    from repro_torch.obs import metrics
    h = metrics.registry("train").snapshot()["histograms"].get("data_us")
    if not h or not h["count"]:
        return None
    return h["p50_us"] / 1e3
