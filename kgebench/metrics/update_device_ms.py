"""The device time a step of the ops that the trainer launched inside its
``step/flush`` and ``step/apply`` spans: the deferred entity update and the
sparse Adagrad of every table (``spans.Attribution.device_ms``)."""

from kgebench.spans import metric_reader

read = metric_reader("update_device_ms")
