"""Serving and training runtime of the port."""
