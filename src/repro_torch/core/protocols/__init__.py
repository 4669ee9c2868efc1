"""Collective protocols as explicit chains of point-to-point hops
(counterpart of ``repro.core.protocols``)."""
