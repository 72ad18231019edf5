"""Measurement scripts of the port, run on the card (see each one's
docstring)."""
