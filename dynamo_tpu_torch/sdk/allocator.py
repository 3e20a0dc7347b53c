"""GPU resource allocator: assign CUDA devices to service workers.

The port's counterpart of the JAX package's ``sdk/allocator.py`` (which
pins TPU chips).  Reference semantics: deploy/dynamo/sdk cli/allocator.py:35-136
— a worker's ``resources={"gpu": n}`` request is pinned to ``n`` devices
through ``CUDA_VISIBLE_DEVICES``.  Workers that request no accelerator get
``CUDA_VISIBLE_DEVICES=""``, so they never open a CUDA context (each costs
card memory).  The device count is ``DYN_TPU_CHIPS`` when set (the JAX
package's knob), else ``torch.cuda.device_count()``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Allocation:
    env: Dict[str, str] = field(default_factory=dict)
    devices: List[int] = field(default_factory=list)


def _device_count() -> int:
    total = int(os.environ.get("DYN_TPU_CHIPS", "0") or 0)
    if total:
        return total
    import torch  # counts devices without opening a CUDA context

    return torch.cuda.device_count()


class GpuAllocator:
    """Hands out device sets worker by worker; oversubscription is an error."""

    def __init__(self, total_devices: Optional[int] = None):
        self.total_devices = _device_count() if total_devices is None else total_devices
        self._next = 0

    def assign(self, resources: Dict) -> Allocation:
        if "tpu" in resources:
            raise ValueError(
                f"resources {resources!r} asks for TPU chips; the port allocates "
                'CUDA devices: request them as {"gpu": n}'
            )
        want = int(resources.get("gpu", 0) or 0)
        if want == 0:
            return Allocation(env={"CUDA_VISIBLE_DEVICES": ""})
        if self._next + want > self.total_devices:
            raise RuntimeError(
                f"GPU oversubscribed: need {want}, "
                f"{self.total_devices - self._next} of {self.total_devices} left"
            )
        devices = list(range(self._next, self._next + want))
        self._next += want
        return Allocation(
            env={"CUDA_VISIBLE_DEVICES": ",".join(map(str, devices))},
            devices=devices,
        )
