"""Cost model and microbenchmark calibration for automatic placement
(port of ``lia_tpu/runtime/cost_model.py``).

- :class:`Microbench` measures the host→card copy (a two-point fit of
  α + bytes/β), the host's fp32 matmul rate and the card's bf16 matmul rate
  on the live machine;
- :class:`CostModel` predicts per-layer prefill and decode times for every
  placement plan and picks (prefill_policy, decode_policy, hbm_percentage)
  under the card's memory budget: the ``auto`` policies;
- :func:`resolve_auto_policies` fills the fields of a
  :class:`~lia_tpu_torch.config.RuntimeConfig` that ask for ``auto`` (-1).

:class:`CostModel` is the reference's arithmetic line for line: for the same
:class:`SystemProfile` it gives the reference's times and picks. The profile's
defaults are the H100's (see :class:`SystemProfile`).

Roofline formulation: t = max(flops / throughput, bytes / bandwidth) per
operator group, plus explicit transfer terms at every placement boundary.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import torch

from lia_tpu_torch.config import ModelConfig, QuantConfig, RuntimeConfig


# Fractions of an H100 SXM5's spec (989 TFLOP/s dense bf16, 3.35 TB/s HBM3)
# and of its memory as torch reports it (85.02 GB) that the port reaches,
# measured on one NVIDIA H100 80GB HBM3 at a 700 W power limit: "flops" the
# bf16 4096^3 matmul rate (Microbench.matmul_flops; chip_smoke.py's calibrate
# phase), "hbm_bw" the weight-read rate of bf16 matmuls at 16 rows over
# OPT-6.7B's projections (tools/fit_cost_model.py --measure), "hbm_bytes" the
# share free to a fresh process (chip_smoke.py's host line).
H100_FIT = {"flops": 0.7743, "hbm_bw": 0.8142, "hbm_bytes": 0.9935}


@dataclass
class SystemProfile:
    """Machine characteristics, the reference's fields (so either package
    takes the same profile). ``tpu_`` names the accelerator, as the
    placement plans' ``"tpu"`` does (:mod:`lia_tpu_torch.runtime.policy`).

    Defaults: one NVIDIA H100 80GB HBM3 (SXM5) at a 700 W power limit and its
    host (8 cores, 108 GB), measured there: the card's rates as the spec
    times :data:`H100_FIT`; the pinned copy's α and β, the host's fp32
    matmul rate at 8 threads and its copy rate by ``chip_smoke.py``'s
    calibrate phase; the launches a decode layer and a step make by
    ``tools/fit_cost_model.py --measure``; the per-launch cost and the
    per-format derates fitted by ``tools/fit_cost_model.py`` on the port's
    resident decode steps at b16 over a 272-token context (``PERF.md`` §5).
    The eager decode loop is bound by host time, so ``op_overhead_s`` carries
    about half of a bf16 step."""

    tpu_flops: float = 989e12 * H100_FIT["flops"]  # bf16 FLOP/s
    hbm_bw: float = 3.35e12 * H100_FIT["hbm_bw"]  # bytes/s of weight reads
    hbm_bytes: float = 85.02e9 * H100_FIT["hbm_bytes"]  # device memory free to the process
    h2d_bw: float = 50.3e9  # host→card copy bandwidth from pinned memory (the β of α + bytes/β)
    # Fixed per-copy latency α: every host↔device copy pays α + bytes/h2d_bw
    # (Microbench.h2d_alpha_beta's two-point fit).
    h2d_latency_s: float = 50e-6
    host_flops: float = 414e9  # the host's fp32 matmul FLOP/s at torch's thread count
    host_mem_bw: float = 44.3e9  # host DRAM bytes a second (a 1 GiB copy, read and write)
    # Effective host cost of one launch of the eager decode loop.
    op_overhead_s: float = 12.0e-6
    ops_per_layer: float = 15.0  # kernels a decoder layer launches at decode
    ops_per_step: float = 33.25  # kernels a decode step launches outside the layers
    # Per-format achieved fractions of hbm_bw for weight reads (fitted; they
    # carry each format's extra host launches, since op_overhead_s is one):
    # dynamic-act int8 and W4A8, weight-only int8, weight-only int4.
    dyn_bw_derate: float = 0.0773
    woq_bw_derate: float = 0.2096
    woq_int4_bw_derate: float = 0.1042


class Microbench:
    """Live calibration on the card and its host."""

    @staticmethod
    def _make_put_time(during_compute: bool):
        """A function timing one copy of n bytes from pinned host memory to the
        card on a side stream, as the weight manager streams layers; with
        ``during_compute``, a 4096^2 bf16 matmul is enqueued on the current
        stream first. The clock stops at the copy stream's sync."""
        dev = torch.device("cuda")
        side = torch.cuda.Stream(dev)
        a = None
        if during_compute:
            a = torch.ones((4096, 4096), dtype=torch.bfloat16, device=dev)
            a @ a  # load the matmul outside the timed region
        bufs = {}

        def put_time(nbytes: int) -> float:
            n = max(nbytes, 1)
            if n not in bufs:
                bufs[n] = (torch.ones(n, dtype=torch.uint8, pin_memory=True),
                           torch.empty(n, dtype=torch.uint8, device=dev))
            src, dst = bufs[n]
            torch.cuda.synchronize()
            if a is not None:
                a @ a  # compute in flight while the copy runs
            t0 = time.perf_counter()
            with torch.cuda.stream(side):
                dst.copy_(src, non_blocking=True)
            side.synchronize()
            dt = time.perf_counter() - t0
            torch.cuda.synchronize()  # drain the compute
            return dt

        return put_time

    @classmethod
    def h2d_alpha_beta(
        cls,
        small: int = 4 << 20,
        large: int = 256 << 20,
        measure=None,
        during_compute: bool = False,
    ) -> Tuple[float, float]:
        """Two-point fit of the transfer model t(b) = α + b/β: α the fixed
        per-copy latency, β the asymptotic bandwidth. ``during_compute=True``
        times each copy with a matmul in flight (the condition streamed decode
        runs under). ``measure`` (n bytes → seconds) is injectable for tests;
        without it a CUDA card is needed."""
        if measure is None:
            if not torch.cuda.is_available():
                raise RuntimeError("Microbench.h2d_alpha_beta needs a CUDA device or a measure")
            measure = cls._make_put_time(during_compute)
        measure(1 << 10)  # warm the path
        t_small = min(measure(small) for _ in range(2))
        t_large = min(measure(large) for _ in range(2))
        if t_large <= t_small:  # noise floor: bandwidth-only fallback
            return 0.0, large / t_large
        beta = (large - small) / (t_large - t_small)
        alpha = max(0.0, t_small - small / beta)
        return alpha, beta

    @staticmethod
    def matmul_flops(device, n: int = 2048, dtype: str = "bfloat16") -> float:
        """FLOP/s of three n^3 matmuls on ``device`` (on the CPU at torch's
        thread count, the host tier's), after one warm-up, synced."""
        device = torch.device(device)
        dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
        a = torch.ones((n, n), dtype=dt, device=device)
        sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
        a @ a
        sync()
        t0 = time.perf_counter()
        for _ in range(3):
            out = a @ a
        sync()
        del out
        return 3 * 2 * n**3 / (time.perf_counter() - t0)

    @classmethod
    def calibrate(cls, profile: Optional[SystemProfile] = None, measure=None) -> SystemProfile:
        """``profile`` (default :class:`SystemProfile`) with the copy's α and β
        (measured with compute in flight), the host's fp32 rate and the card's
        bf16 rate measured. A failed measurement raises (the reference keeps
        its defaults). Without a card it raises unless ``measure`` is given,
        and then the card's rate keeps its value."""
        p = profile or SystemProfile()
        alpha, beta = cls.h2d_alpha_beta(measure=measure, during_compute=True)
        p = replace(p, h2d_bw=beta, h2d_latency_s=alpha)
        p = replace(p, host_flops=cls.matmul_flops("cpu", 1024, "float32"))
        if torch.cuda.is_available():
            p = replace(p, tpu_flops=cls.matmul_flops("cuda", 4096))
        return p


@dataclass
class CostModel:
    cfg: ModelConfig
    profile: SystemProfile
    quant: QuantConfig = QuantConfig()

    # -- sizes -----------------------------------------------------------------

    def weight_bytes_per_layer(self) -> float:
        c = self.cfg
        per_param = {"int8": 1.0, "int4": 0.5}.get(self.quant.weight_dtype, 2.0)
        qd, kd = c.num_heads * c.head_dim, c.num_kv_heads * c.head_dim
        n_mlp = 3 if c.activation.value == "silu" else 2
        params = c.hidden_size * (qd + 2 * kd) + qd * c.hidden_size + n_mlp * c.hidden_size * c.ffn_size
        return params * per_param

    def kv_bytes_per_layer(self, B: int, s_len: int) -> float:
        c = self.cfg
        per = 1.0 if self.quant.kv_cache_dtype == "int8" else 2.0
        return 2 * B * c.num_kv_heads * s_len * c.head_dim * per

    def layer_flops(self, B: int, S: int, s_ctx: int) -> float:
        c = self.cfg
        qd, kd = c.num_heads * c.head_dim, c.num_kv_heads * c.head_dim
        n_mlp = 3 if c.activation.value == "silu" else 2
        lin = 2 * B * S * (c.hidden_size * (qd + 2 * kd) + qd * c.hidden_size
                           + n_mlp * c.hidden_size * c.ffn_size)
        attn = 2 * B * S * s_ctx * c.num_heads * c.head_dim * 2
        return lin + attn

    # -- per-layer times by plan -------------------------------------------------

    def weight_bw_derate(self) -> float:
        """Achieved fraction of hbm_bw for weight reads, by format (fitted)."""
        p, q = self.profile, self.quant
        if q.weight_dtype not in ("int8", "int4"):
            return 1.0
        if q.act_quant == "dynamic":
            return p.dyn_bw_derate
        return p.woq_int4_bw_derate if q.weight_dtype == "int4" else p.woq_bw_derate

    def tpu_layer_time(self, B: int, S: int, s_ctx: int, weights_resident: bool) -> float:
        p = self.profile
        flops = self.layer_flops(B, S, s_ctx)
        w_bw = p.hbm_bw * self.weight_bw_derate()
        bytes_t = (
            self.weight_bytes_per_layer() / w_bw
            + self.kv_bytes_per_layer(B, s_ctx) / p.hbm_bw
        )
        t = max(flops / p.tpu_flops, bytes_t)
        t += p.ops_per_layer * p.op_overhead_s  # effective per-op cost (see profile)
        if not weights_resident:
            # streamed: transfer overlapped with compute, bound by the slower
            t = max(t, self.h2d_time(self.weight_bytes_per_layer()))
        return t

    def h2d_time(self, nbytes: float, n_puts: int = 1) -> float:
        """α + bytes/β per copy (see SystemProfile.h2d_latency_s)."""
        p = self.profile
        return n_puts * p.h2d_latency_s + nbytes / p.h2d_bw

    def predict_decode_step(self, B: int, s_ctx: int, resident: bool = True) -> float:
        """Full-model decode step time."""
        c, p = self.cfg, self.profile
        t = c.num_layers * self.tpu_layer_time(B, 1, s_ctx, resident)
        per_param = {"int8": 1.0, "int4": 0.5}.get(self.quant.weight_dtype, 2.0)
        if self.quant.enabled and self.quant.quant_lm_head:
            head_bytes = c.vocab_size * c.embed_dim * per_param
            head_bw = p.hbm_bw * self.weight_bw_derate()
        else:
            head_bytes = c.vocab_size * c.embed_dim * 2
            head_bw = p.hbm_bw
        t += head_bytes / head_bw + p.ops_per_step * p.op_overhead_s
        return t

    def host_layer_time(self, B: int, S: int, s_ctx: int) -> float:
        p = self.profile
        flops = self.layer_flops(B, S, s_ctx)
        bytes_rw = self.weight_bytes_per_layer() + self.kv_bytes_per_layer(B, s_ctx)
        return max(flops / p.host_flops, bytes_rw / p.host_mem_bw)

    def hybrid_decode_layer_time(self, B: int, s_ctx: int, weights_resident: bool) -> float:
        """Policy 2/4: card linears + host attention over host KV."""
        c, p = self.cfg, self.profile
        lin = self.tpu_layer_time(B, 1, 0, weights_resident)
        qkv_bytes = B * (c.num_heads + 2 * c.num_kv_heads) * c.head_dim * 2 * 2  # q,k,v + attn_out
        # D2H qkv + H2D attn_out, both charged at the H2D-calibrated alpha/beta
        xfer = self.h2d_time(qkv_bytes, n_puts=2)
        attn_flops = 2 * B * s_ctx * c.num_heads * c.head_dim * 2
        host_attn = max(attn_flops / p.host_flops, self.kv_bytes_per_layer(B, s_ctx) / p.host_mem_bw)
        return lin + xfer + host_attn

    def policy0_decode_layer_time(self, B: int, s_ctx: int) -> float:
        """Policy 0 decode: stream KV planes host→card every token."""
        t_kv = self.h2d_time(self.kv_bytes_per_layer(B, s_ctx))
        return self.tpu_layer_time(B, 1, s_ctx, weights_resident=False) + t_kv

    # -- placement search ---------------------------------------------------------

    def max_resident_layers(self, B: int, max_len: int) -> int:
        c, p = self.cfg, self.profile
        embed = c.vocab_size * c.embed_dim * 2 * (1 if c.tie_embeddings else 2)
        budget = p.hbm_bytes - embed - 2 * B * max_len * c.hidden_size * 2  # activations slack
        per_layer = self.weight_bytes_per_layer() + self.kv_bytes_per_layer(B, max_len)
        return max(0, min(c.num_layers, int(budget // max(per_layer, 1))))

    def choose(self, B: int, in_len: int, out_len: int) -> Tuple[int, int, int]:
        """Pick (prefill_policy, decode_policy, hbm_percentage) minimizing total time."""
        c = self.cfg
        max_len = in_len + out_len
        n_res = self.max_resident_layers(B, max_len)
        L = c.num_layers
        hbm_pct = int(100 * n_res / L)
        n_str = L - n_res

        if n_str == 0:
            return 3, 3, 100

        # prefill candidates for streamed layers: 0 (card, streamed) vs 1 (host)
        t_pf = {
            0: self.tpu_layer_time(B, in_len, in_len, weights_resident=False),
            1: self.host_layer_time(B, in_len, in_len),
        }
        # decode candidates (per token): 0 / 1 / 2
        s_ctx = in_len + out_len // 2
        t_dec = {
            0: self.policy0_decode_layer_time(B, s_ctx),
            1: self.host_layer_time(B, 1, s_ctx),
            2: self.hybrid_decode_layer_time(B, s_ctx, weights_resident=False),
        }
        pf = min(t_pf, key=t_pf.get)
        dec = min(t_dec, key=t_dec.get)
        return pf, dec, hbm_pct

    def report(self, B: int, in_len: int, out_len: int) -> Dict[str, float]:
        pf, dec, pct = self.choose(B, in_len, out_len)
        s_ctx = in_len + out_len // 2
        return {
            "prefill_policy": pf,
            "decode_policy": dec,
            "hbm_percentage": pct,
            "weight_bytes_per_layer": self.weight_bytes_per_layer(),
            "kv_bytes_per_layer": self.kv_bytes_per_layer(B, in_len + out_len),
            "t_prefill_tpu_streamed": self.tpu_layer_time(B, in_len, in_len, False),
            "t_prefill_host": self.host_layer_time(B, in_len, in_len),
            "t_decode_policy0": self.policy0_decode_layer_time(B, s_ctx),
            "t_decode_host": self.host_layer_time(B, 1, s_ctx),
            "t_decode_hybrid": self.hybrid_decode_layer_time(B, s_ctx, False),
        }


def resolve_auto_policies(
    cfg: ModelConfig,
    runtime: RuntimeConfig,
    batch: int,
    in_len: int,
    out_len: int,
    calibrate: bool = False,
) -> RuntimeConfig:
    """Fill in the policies and ``hbm_percentage`` where the runtime asks for
    ``auto`` (-1); a percentage below 100 also sets ``stream_weights``. The
    profile is the detected card's (:func:`system_profile_defaults`), measured
    by :meth:`Microbench.calibrate` with ``calibrate``."""
    from lia_tpu_torch.utils.device_caps import system_profile_defaults

    profile = system_profile_defaults()
    if calibrate:
        profile = Microbench.calibrate(profile)
    cm = CostModel(cfg, profile, runtime.quant)
    pf, dec, pct = cm.choose(batch, in_len, out_len)
    kw = {}
    if runtime.prefill_policy == -1:
        kw["prefill_policy"] = pf
    if runtime.decode_policy == -1:
        kw["decode_policy"] = dec
    if runtime.hbm_percentage == -1:
        kw["hbm_percentage"] = pct
        if pct < 100:
            kw["stream_weights"] = True
    return runtime.replace(**kw) if kw else runtime
