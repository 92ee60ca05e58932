"""Model workflows of the port (counterparts of ``models/``)."""
