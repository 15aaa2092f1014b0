"""The device time a step of the ops launched while the trainer was in its
``step/backward`` span, autograd's device thread's launches included: the
gradients with respect to the workspace rows (``spans.Attribution.device_ms``)."""

from kgebench.spans import metric_reader

read = metric_reader("backward_device_ms")
