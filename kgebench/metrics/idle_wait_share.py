"""The share of the traced window in which the device ran nothing while the
trainer waited in ``pipeline/wait`` for the sampler's next batch
(``spans.Attribution.idle_us``)."""

from kgebench.spans import metric_reader

read = metric_reader("idle_wait_share")
