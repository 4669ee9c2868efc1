"""Training tier of the port (counterpart of ``repro.train``)."""
