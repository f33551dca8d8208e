"""One adapter per system the benchmark drives, found by the ``system`` key
of a configuration file: ``portbench/systems/<system>.py``."""
