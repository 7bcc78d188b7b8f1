"""Measurement tools of the port: tracing and per-layer timing on the card
(``profiling``)."""
