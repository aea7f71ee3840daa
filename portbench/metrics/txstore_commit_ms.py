"""Median host ms of a training step's transactional commit, by the
Trainer's own clock: the ``commit_us`` histogram in
``repro_torch.obs.metrics.registry("train")`` (``commit_step``, the
OptSVA-CF write transaction over params, opt and the data cursor), over
every step the process ran."""


def read(record):
    if record.get("kind") != "train":
        return None
    from repro_torch.obs import metrics
    h = metrics.registry("train").snapshot()["histograms"].get("commit_us")
    if not h or not h["count"]:
        return None
    return h["p50_us"] / 1e3
