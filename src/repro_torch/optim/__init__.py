from repro_torch.optim.api import make_optimizer

__all__ = ["make_optimizer"]
