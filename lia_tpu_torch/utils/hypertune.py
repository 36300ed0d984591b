"""Hypertune: grid search over the placement knobs (port of ``lia_tpu/utils/hypertune.py``).

The search space is the LIA policy surface, (prefill_policy, decode_policy,
hbm_percentage, num_minibatch); the objective is the measured generation
throughput on a short probe workload. A candidate that fails is skipped, as
in the reference, but kept in :attr:`Hypertune.failures` with its message, so
that a caller can fail on it.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from lia_tpu_torch.config import GenerationConfig, ModelConfig, QuantConfig, RuntimeConfig


@dataclass
class TuneResult:
    runtime: RuntimeConfig
    tokens_per_s: float
    total_s: float


@dataclass
class Hypertune:
    cfg: ModelConfig
    params_host: Any
    gen: GenerationConfig = GenerationConfig(max_new_tokens=8)
    batch: int = 4
    input_tokens: int = 64
    quant: QuantConfig = QuantConfig()
    prefill_policies: Sequence[int] = (0, 3)
    decode_policies: Sequence[int] = (1, 2, 3)
    hbm_percentages: Sequence[int] = (0, 50, 100)
    num_minibatches: Sequence[int] = (1, 2)
    device: Any = None  # the engines' device (default: the card)
    failures: List[Tuple[RuntimeConfig, str]] = field(default_factory=list)

    def candidates(self) -> List[RuntimeConfig]:
        out = []
        for pf, dec, pct, nm in itertools.product(
            self.prefill_policies, self.decode_policies, self.hbm_percentages, self.num_minibatches
        ):
            if pct == 100 and (pf != 3 or dec != 3):
                continue  # policies only apply to non-resident layers
            out.append(
                RuntimeConfig(
                    prefill_policy=pf,
                    decode_policy=dec,
                    hbm_percentage=pct,
                    num_minibatch=nm,
                    stream_weights=pct < 100,
                    quant=self.quant,
                )
            )
        return out

    def run(self, verbose: bool = True) -> List[TuneResult]:
        """Each candidate's engine over the same seeded prompts: one warm-up
        generate, then one timed (the clock stops after a device sync). The
        results best first; the failed candidates in :attr:`failures`."""
        import torch

        from lia_tpu_torch.engine.engine import InferenceEngine

        rng = np.random.default_rng(0)
        prompts = [
            list(rng.integers(10, self.cfg.vocab_size - 10, size=self.input_tokens))
            for _ in range(self.batch)
        ]
        cuda = self.device is None or torch.device(self.device).type == "cuda"
        sync = torch.cuda.synchronize if cuda else (lambda: None)
        results = []
        self.failures = []
        for rt in self.candidates():
            eng = None
            try:
                eng = InferenceEngine(self.cfg, self.params_host, rt, device=self.device)
                eng.generate(prompts, self.gen)  # warm-up
                sync()
                t0 = time.perf_counter()
                res = eng.generate(prompts, self.gen)
                sync()
                dt = time.perf_counter() - t0
                tps = res.sequences.size / dt
                results.append(TuneResult(rt, tps, dt))
                if verbose:
                    print(
                        f"[hypertune] pf={rt.prefill_policy} dec={rt.decode_policy} "
                        f"hbm%={rt.hbm_percentage} nm={rt.num_minibatch}: {tps:.1f} tok/s"
                    )
            except Exception as e:  # the candidate cannot run here: record it and go on
                self.failures.append((rt, f"{type(e).__name__}: {e}"))
                if verbose:
                    print(f"[hypertune] candidate failed: {e}")
            finally:
                if eng is not None and eng.scheduler is not None:
                    eng.scheduler.wm.close()
                del eng
        results.sort(key=lambda r: -r.tokens_per_s)
        return results

    def best(self) -> Optional[TuneResult]:
        results = self.run(verbose=False)
        return results[0] if results else None
