"""The share of the trainer's ``engine/step`` time in which the sampler
thread was inside a ``pipeline/sample`` span: how much of sampling the
step hides (``spans.Attribution.sample_overlap``)."""

from kgebench.spans import metric_reader

read = metric_reader("sample_overlap_share")
