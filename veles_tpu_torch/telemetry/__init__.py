"""Counters of the port's serving path."""
