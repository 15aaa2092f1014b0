"""The device time a step of the ops that the trainer launched inside its
``step/gather`` span: the workspace rows gathered from the tables
(``spans.Attribution.device_ms``)."""

from kgebench.spans import metric_reader

read = metric_reader("gather_device_ms")
