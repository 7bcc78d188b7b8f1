"""Measurement tools of the port: the reference's benchmark suite
(``suite``: the 21 scene rows, ``run_scene``, ``run_suite``), its
metric collector (``collector``) and system sampler (``sysmon``), and
tracing and per-layer timing on the card (``profiling``)."""
