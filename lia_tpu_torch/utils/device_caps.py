"""GPU capability registry (port of ``lia_tpu/utils/device_caps.py``).

The reference keeps each TPU generation's roofline numbers; the port keeps
each NVIDIA card's, from the public spec sheets (dense tensor-core rates,
without sparsity). The cost model's profile is seeded from the detected card
(:func:`system_profile_defaults`) and can be overridden by live
microbenchmarks (:meth:`lia_tpu_torch.runtime.cost_model.Microbench.calibrate`).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch


@dataclass(frozen=True)
class GpuCaps:
    name: str
    bf16_flops: float  # peak dense bf16 FLOP/s per card
    int8_ops: float  # peak dense int8 OP/s per card
    hbm_bytes: float
    hbm_bw: float  # bytes/s
    link_bw: float  # NVLink bytes/s a direction (0: none)


REGISTRY = {
    "h100-sxm": GpuCaps("h100-sxm", 989e12, 1979e12, 80e9, 3.35e12, 450e9),
    "h100-pcie": GpuCaps("h100-pcie", 756e12, 1513e12, 80e9, 2.0e12, 0.0),
}

# The card's name as torch.cuda.get_device_name() gives it, to a registry key
# (the PCIe card's name ends in "PCIe"; the SXM5 card's does not).
_NAMES = (("h100 pcie", "h100-pcie"), ("h100", "h100-sxm"))


def detect() -> Optional[GpuCaps]:
    """The local card's capabilities, with ``hbm_bytes`` from the card itself;
    None where no CUDA card is present (CUDA is not initialised then) or the
    card is not in the registry."""
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(0).lower()
    for pattern, key in _NAMES:
        if pattern in name:
            return replace(REGISTRY[key], hbm_bytes=float(torch.cuda.get_device_properties(0).total_memory))
    return None


def system_profile_defaults():
    """The cost model's profile seeded from the detected card: its peak rates
    and memory times the fractions fitted on an H100 SXM5
    (:data:`lia_tpu_torch.runtime.cost_model.H100_FIT`); the H100 defaults of
    :class:`~lia_tpu_torch.runtime.cost_model.SystemProfile` where none is
    detected."""
    from lia_tpu_torch.runtime.cost_model import H100_FIT, SystemProfile

    caps = detect()
    if caps is None:
        return SystemProfile()
    return SystemProfile(
        tpu_flops=caps.bf16_flops * H100_FIT["flops"],
        hbm_bw=caps.hbm_bw * H100_FIT["hbm_bw"],
        hbm_bytes=caps.hbm_bytes * H100_FIT["hbm_bytes"],
    )
