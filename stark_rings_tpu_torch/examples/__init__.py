"""Protocols driven through the port's surface (counterparts of the
repository's ``examples/``)."""
