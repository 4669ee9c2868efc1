"""Runtime of the port: in-process ranks (``substrate``) and the elastic
runtime around them (``watchdog``, ``health``, ``ctrlplane``,
``elastic``, ``controller``)."""
