"""Share of the H100's bf16 peak in the decode steps: the decoded tokens'
model FLOPs (their layers, the LM head, attention over the keys each sees)
over the Server's decode seconds (``timing["decode_s"]``)."""
from portbench import counts
from portbench.drivers.serve import served_flops


def read(record):
    if record.get("kind") != "serve" or not record["timing"].get("decode_s"):
        return None
    flops = served_flops(record["model"], record["served"], prompts=False)
    return (flops / record["timing"]["decode_s"] / counts.PEAK_FLOPS_BF16
            * 100)
