"""The share of the traced window in which the device ran nothing while the
trainer was inside ``engine/step`` or a ``step/*`` span: the device waiting
for the host to enqueue the step (``spans.Attribution.idle_us``)."""

from kgebench.spans import metric_reader

read = metric_reader("idle_enqueue_share")
