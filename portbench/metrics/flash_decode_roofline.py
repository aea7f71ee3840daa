"""Roofline share of K1's decode (``ops.attention`` with one query position):
its calls' least time from their shapes over the device time in their
ranges."""
from portbench.calls import roofline_share


def read(record):
    return roofline_share(record, "ops.attention flash_decode")
