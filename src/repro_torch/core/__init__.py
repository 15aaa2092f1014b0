"""DGL-KE core in PyTorch: scores, losses, samplers, the train step and the
single-machine model adapter."""
