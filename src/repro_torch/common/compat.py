"""The port's version-sensitive torch symbols, in one place.

The JAX package keeps every version-sensitive JAX symbol in its
common/compat.py; the port does the same for torch. Two such symbols:

  * the ``"fake"`` process-group backend and its ``FakeStore``, from
    ``torch.testing._internal.distributed.fake_pg`` (an internal module
    whose contents moved between releases): a world of any size in one
    process whose collectives do nothing. The dry run joins one as rank 0
    (``init_fake_world``). A torch without it raises: the dry run has no
    other route.
  * ``torch.utils.flop_counter``'s formula registry (aten overload packet
    -> FLOPs of one call; the registry's name and its functions'
    keywords are not public API) and its ``FlopCounterMode``;
  * ``torch.cuda._sleep``, a kernel that spins for a number of clock
    cycles: a measurement holds the stream with it while the host
    enqueues the calls it times (``device_sleep``).

Nothing else in the port imports ``torch.testing._internal`` or
``torch.utils.flop_counter`` (``tests/test_torch_imports.py``).
"""

from __future__ import annotations

import datetime
from typing import Callable, Optional

import torch
import torch.distributed as dist


# ------------------------------------------------------------ the fake world
def init_fake_world(world_size: int, rank: int = 0,
                    timeout_s: float = 60.0) -> None:
    """Join a ``"fake"``-backend world of ``world_size`` ranks as ``rank``.

    Refuses to start when this process already has a default group (a
    test's gloo world, say); the caller destroys the fake one
    (``dist.destroy_process_group()``) in a ``finally``."""
    if dist.is_initialized():
        raise RuntimeError("a default process group exists already: the fake "
                           "world of the dry run needs a process of its own")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(f"this torch ({torch.__version__}) has no fake "
                           "process-group backend") from e
    if "fake" not in dist.Backend.backend_list:
        raise RuntimeError(f"this torch ({torch.__version__}) registers no "
                           "'fake' process-group backend")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


# ------------------------------------------------------------ FLOP formulas
def flop_formula(func) -> Optional[Callable]:
    """The FLOP formula of an aten op (an ``OpOverload``) in the registry
    ``FlopCounterMode`` counts by, or None: ``formula(args, kwargs, out) ->
    FLOPs`` of one call."""
    from torch.utils.flop_counter import flop_registry

    f = flop_registry.get(func.overloadpacket)
    if f is None:
        return None
    return lambda args, kwargs, out: int(f(*args, **kwargs, out_val=out))


def flop_counter_mode():
    """torch's own ``FlopCounterMode``, silent: the framework's count of the
    same program beside the dry run's (its ``get_total_flops()``)."""
    from torch.utils.flop_counter import FlopCounterMode

    return FlopCounterMode(display=False)


# ------------------------------------------------------------ timing
def device_sleep(cycles: int) -> None:
    """Keep the current CUDA stream busy for about ``cycles`` clock cycles,
    so that calls enqueued meanwhile run back to back on the card."""
    torch.cuda._sleep(int(cycles))
