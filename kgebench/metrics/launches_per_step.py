"""The CUDA runtime calls (kernel launches, memcpy, memset) that the trainer
thread made inside its ``engine/step`` spans, a traced step: what the host
enqueues for one step (``spans.Attribution.launches``)."""

from kgebench.spans import metric_reader

read = metric_reader("launches_per_step")
