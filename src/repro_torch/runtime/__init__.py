"""Serving runtime of the port (training comes in slice 2)."""
