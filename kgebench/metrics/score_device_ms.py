"""The device time a step of the ops that the trainer launched inside its
``step/score`` span: the forward of the scores and the loss
(``spans.Attribution.device_ms``)."""

from kgebench.spans import metric_reader

read = metric_reader("score_device_ms")
