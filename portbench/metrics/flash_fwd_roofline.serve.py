"""Roofline share of K1 in serving's prefills (``ops.attention`` with more
than one query position): its calls' least time from their shapes over the
device time in their ranges."""
from portbench.calls import roofline_share


def read(record):
    return roofline_share(record, "ops.attention flash_fwd")
