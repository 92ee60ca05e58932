"""AcceleratedUnit / AcceleratedWorkflow: units that own a device
(counterpart of ``veles_tpu/accelerated.py``).

The device is a ``torch.device`` resolved by :func:`backends.device_for`:
the card (``cuda:0``) unless the caller asks for ``"cpu"``, and an error
when the card is asked for and there is none. PyTorch runs eagerly, so
the reference's jit cache has no counterpart here; a unit's device work
is its ``torch_run``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .backends import device_for
from .units import Unit
from .workflow import Workflow


class AcceleratedUnit(Unit):
    """Compute unit bound to the workflow's device."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.device: Optional[torch.device] = None

    def initialize(self, device=None, **kwargs):
        res = super().initialize(device=device, **kwargs)
        if res:
            return res
        self.device = device_for(device)
        return None

    def run(self) -> None:
        self.torch_run()

    def torch_run(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError("%s.torch_run" % type(self).__name__)


class AcceleratedWorkflow(Workflow):
    """Workflow owning a device: every unit initialises on it."""

    hide_from_registry = True

    def __init__(self, workflow=None, **kwargs):
        super().__init__(workflow, **kwargs)
        self.device: Optional[torch.device] = None

    def initialize(self, device=None, **kwargs):
        self.device = device_for(device)
        return super().initialize(device=self.device, **kwargs)
