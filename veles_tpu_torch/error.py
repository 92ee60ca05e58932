"""Framework exception types (counterpart of ``veles_tpu/error.py``)."""


class VelesError(Exception):
    """Base class for all framework errors."""
