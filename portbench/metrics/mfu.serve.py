"""Share of the H100's bf16 peak in the window's useful model FLOPs: every
prompt token and every decoded token of the requests served (2 N_active a
token, the LM head once for each served token, attention over the valid
pairs), over the window's seconds (the profiler's own left out)."""
from portbench import counts
from portbench.drivers.serve import served_flops


def read(record):
    if record.get("kind") != "serve" or not record.get("served"):
        return None
    seconds = record["window_s"] - record.get("profiler_s", 0.0)
    flops = served_flops(record["model"], record["served"], prompts=True)
    return flops / seconds / counts.PEAK_FLOPS_BF16 * 100
