"""Roofline share of K1b (``ops.attention_bwd``): its calls' least time from
their shapes over the device time in their ranges."""
from portbench.calls import roofline_share


def read(record):
    return roofline_share(record, "ops.attention_bwd")
