"""Runtime of the port: in-process ranks (``substrate``)."""
