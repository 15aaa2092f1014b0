"""The port's twins of the repository's examples/, run as modules:

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.train_fb15k_scale
    PYTHONPATH=src python -m repro_torch.examples.distributed_kge --device cpu
    PYTHONPATH=src python -m repro_torch.examples.serve_lm

Each takes ``--device`` (cuda by default; cpu runs the kernels' plain
versions).
"""
