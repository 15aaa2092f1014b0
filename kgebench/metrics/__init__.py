"""One reader a metric, ``<metric>.py``, found by the metric's name in
``BENCHMARK.json``: ``read(record) -> float or None`` from the run's
``harness.Record``. A reader that finds nothing to read returns None, and
the run leaves that metric out of its line."""
