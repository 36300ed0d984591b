"""Placement policies: per-(phase, operator-group) execution plans
(port of ``lia_tpu/runtime/policy.py``).

LIA's policies (lia/modeling_opt.py:1167-1176) over the device pair
(CUDA card ↔ host CPU and DRAM):

| policy | weights         | attention | KV cache | meaning                          |
|--------|-----------------|-----------|----------|----------------------------------|
| 0      | streamed → card | card      | host     | card compute, KV stored on host  |
| 1      | host            | host      | host     | all on the CPU                   |
| 2      | streamed → card | host      | host     | card linears, host attention     |
| 3      | card-resident   | card      | card     | resident layers (gpu_percentage) |
| 4      | streamed → card | host      | host     | decode variant of 2              |

The first ``hbm_percentage``% of layers always run policy 3; the rest follow
the phase's policy. The reference's ``auto`` policies need its cost model,
which is not ported: :class:`~lia_tpu_torch.config.RuntimeConfig` takes
integer policies here.
"""

from __future__ import annotations

from dataclasses import dataclass

from lia_tpu_torch.config import RuntimeConfig


@dataclass(frozen=True)
class Plan:
    """Execution plan for the non-resident layers of one phase."""

    weights: str  # "streamed" (host → card per layer) | "host" (stay in DRAM)
    attention: str  # "tpu" (the accelerator, named as in the reference) | "host"
    kv: str  # "hbm" (device memory) | "host"

    @property
    def all_host(self) -> bool:
        return self.weights == "host" and self.attention == "host"

    @property
    def hybrid(self) -> bool:
        """Linears on the card, attention on the host (the decode-policy-2 shape)."""
        return self.weights != "host" and self.attention == "host"


_PLANS = {
    0: Plan(weights="streamed", attention="tpu", kv="host"),
    1: Plan(weights="host", attention="host", kv="host"),
    2: Plan(weights="streamed", attention="host", kv="host"),
    3: Plan(weights="streamed", attention="tpu", kv="hbm"),  # non-resident tail
    4: Plan(weights="streamed", attention="host", kv="host"),
}


def plan_for(policy: int) -> Plan:
    if policy not in _PLANS:
        raise ValueError(f"unknown policy {policy}; known: {sorted(_PLANS)}")
    return _PLANS[policy]


def phase_plans(runtime: RuntimeConfig):
    """(prefill_plan, decode_plan) for the non-resident layers."""
    return plan_for(runtime.prefill_policy), plan_for(runtime.decode_policy)


def uses_host_kv(runtime: RuntimeConfig) -> bool:
    p, d = phase_plans(runtime)
    return p.kv == "host" or d.kv == "host"
