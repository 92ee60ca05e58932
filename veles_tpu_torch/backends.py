"""Device resolution (counterpart of ``veles_tpu/backends.py``
``Device_for``/``XLADevice``).

The port runs on the CUDA card unless the caller asks for the CPU:
``"auto"`` (or ``None``) and ``"cuda[:N]"`` resolve to a CUDA device and
RAISE when there is none — a run meant for the card never drifts onto
the CPU unnoticed. ``"cpu"`` is for tests and host-side tools.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .error import VelesError
from .ops.precision import apply_f32_policy


def device_for(device: Optional[Union[str, torch.device]] = None
               ) -> torch.device:
    """Resolve ``"auto" | "cuda[:N]" | "cpu"`` (or a ``torch.device``)
    to a ``torch.device``, applying the f32 matmul policy on the way."""
    if device is None or device == "auto":
        device = "cuda:0"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise VelesError(
                "device %r needs a CUDA card and none is available; pass "
                "device='cpu' to run on the host" % (str(device),))
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise VelesError("unsupported device %r (have: auto, cuda, cpu)"
                         % (str(device),))
    apply_f32_policy()
    return dev
