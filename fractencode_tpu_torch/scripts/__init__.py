"""Measurement scripts of the port, each run as ``python -m``."""
