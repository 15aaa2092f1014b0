"""One file a model: the products of its scores in one step (``products``)
and the tables its score reads (``READS``), for ``cost/step.py``."""
