"""Model parallelism of the port (counterpart of ``repro.parallel``):
``sharding`` splits the model over the mesh's "model" axis."""
