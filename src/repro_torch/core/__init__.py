"""The composed collective library of the port: topology and cost model,
the function registry and composition, the plan, the protocols, tiers,
compression, the engine and the application scan (counterpart of
``repro.core``)."""
