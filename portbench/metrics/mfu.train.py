"""Share of the H100's bf16 peak in the window's training: 6 N_active a
token plus the tied or untied LM head, plus causal attention (forward and
backward, 3 x 4 hd a valid pair and head), no recompute counted, over the
window's seconds (the profiler's own left out)."""
from portbench import counts


def read(record):
    if record.get("kind") != "train" or not record.get("steps"):
        return None
    seconds = record["window_s"] - record["profiler_s"]
    return (record["steps"] * record["model"]["flops_per_step"] / seconds
            / counts.PEAK_FLOPS_BF16 * 100)
