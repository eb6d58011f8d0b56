"""Serving runtime of the port."""
