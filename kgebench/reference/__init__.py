"""The plain PyTorch reference of a training step: ``train.py`` drives it,
``<model>.py`` holds each model's scores. It imports nothing of the port."""
