"""Roofline share of K1 with its LSE in training (``ops.attention_fwd``): its
calls' least time from their shapes over the device time in their ranges."""
from portbench.calls import roofline_share


def read(record):
    return roofline_share(record, "ops.attention_fwd")
