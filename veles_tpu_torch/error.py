"""Framework exception types (counterpart of ``veles_tpu/error.py``)."""


class VelesError(Exception):
    """Base class for all framework errors."""


class Bug(VelesError):
    """Internal invariant violation — indicates a framework bug."""


class BadUnitLink(VelesError):
    """Raised when control/data links form an invalid graph."""


class NoMoreJobs(VelesError):
    """Raised by a data source when the epoch/job stream is exhausted."""
