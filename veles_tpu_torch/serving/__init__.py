"""Request-plane bookkeeping of the port's serving path."""
