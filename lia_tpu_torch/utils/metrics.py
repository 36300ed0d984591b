"""Latency/throughput metrics.

Parity with the reference's reporting: per-token wall-clock list threaded through
generation (greedy_search.py:424,455-458) and the summary block printing total,
first-token, and avg/p90/p99 2nd+ token latency
(single_instance/run_generation.py:337-354).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class LatencyStats:
    token_latencies_s: List[float] = field(default_factory=list)  # per generated token

    def record(self, seconds: float) -> None:
        self.token_latencies_s.append(seconds)

    def summary(self, batch: int = 1) -> Dict[str, float]:
        lats = self.token_latencies_s
        if not lats:
            return {}
        rest = sorted(lats[1:]) or [0.0]

        def pct(p: float) -> float:
            idx = min(len(rest) - 1, int(round(p * (len(rest) - 1))))
            return rest[idx]

        total = sum(lats)
        return {
            "total_latency_s": total,
            "first_token_latency_s": lats[0],
            "avg_2nd_token_latency_s": sum(rest) / len(rest),
            "p50_2nd_token_latency_s": pct(0.50),
            "p90_2nd_token_latency_s": pct(0.90),
            "p99_2nd_token_latency_s": pct(0.99),
            "decode_tokens_per_s": (len(lats) - 1) * batch / max(sum(lats[1:]), 1e-9),
            "total_tokens_per_s": len(lats) * batch / max(total, 1e-9),
        }


def format_summary(s: Dict[str, float]) -> str:
    lines = ["---- latency summary ----"]
    for k, v in s.items():
        lines.append(f"{k:>28s}: {v:.6f}")
    return "\n".join(lines)
