"""Three-term roofline of one rank's step on an NVIDIA H100, from a dry-run
record (``launch.dryrun.run_cell``).

Per (arch x shape x mesh) cell:

  compute term    = the rank's FLOPs / the card's peak bf16 rate
  memory term     = the rank's bytes moved / the HBM rate
  collective term = the bytes the rank sends / one NVLink direction

The card: NVIDIA H100 SXM5 80GB at its 700 W limit, from NVIDIA's data
sheet (dense rates, no sparsity): 989 TFLOP/s in bf16, 3.35 TB/s of HBM3,
and NVLink 4 at 900 GB/s a card, 450 GB/s in each direction, which is the
rate at which a rank sends. A card set below 700 W runs slower than these.

The dry run counts what eager PyTorch runs on the rank (no fusion), so
``bytes_accessed`` is what the port moves, not what a fused program would.
``analysis.hlo`` of the reference has no counterpart: torch has no HLO,
and the Dist's observer counts the collectives (``sharding.counting``).

MODEL_FLOPS references:
  train   6 * N * tokens          (fwd+bwd, dense counting)
  decode  2 * N_active * tokens   (one token per sequence)
  prefill 2 * N_active * tokens
The traced/model ratio flags recompute and redundant work; quadratic
attention FLOPs legitimately push it above 1 at long context.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.configs import SHAPES, get_arch

PEAK_FLOPS = 989e12           # bf16 dense / card
HBM_BW = 3.35e12              # B/s / card
LINK_BW = 450e9               # B/s a rank sends over NVLink, one direction


@dataclass(frozen=True)
class Roofline:
    arch: str
    shape: str
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops_per_dev: float
    hlo_flops_per_dev: float          # the traced step's FLOPs (JAX's name)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline-optimistic step time: terms overlap perfectly, so the
        max dominates."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        return (self.model_flops_per_dev / self.hlo_flops_per_dev
                if self.hlo_flops_per_dev else 0.0)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the step spent on the USEFUL compute roofline:
        (model flops / peak) / step_time — the MFU the traced step would
        achieve if every term ran at the card's limit."""
        t_use = self.model_flops_per_dev / PEAK_FLOPS
        return t_use / self.step_time_s if self.step_time_s else 0.0


def model_flops_per_device(arch: str, shape_name: str, n_devices: int
                           ) -> float:
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        total = 6.0 * cfg.active_param_count() * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        total = 2.0 * cfg.active_param_count() * tokens
    else:  # decode: one token per sequence
        total = 2.0 * cfg.active_param_count() * shape.global_batch
    return total / n_devices


def from_dryrun(res: Dict) -> Optional[Roofline]:
    """A Roofline from one ``dryrun.run_cell`` record (None unless it is
    ok). The port charges an in-place cache write its slice, so
    ``bytes_accessed_inplace`` equals ``bytes_accessed``."""
    if res.get("status") != "ok":
        return None
    coll = res.get("collectives", {}).get("total_bytes", 0.0)
    nbytes = res.get("bytes_accessed_inplace", res["bytes_accessed"])
    return Roofline(
        arch=res["arch"], shape=res["shape"],
        compute_s=res["flops"] / PEAK_FLOPS,
        memory_s=nbytes / HBM_BW,
        collective_s=coll / LINK_BW,
        model_flops_per_dev=model_flops_per_device(
            res["arch"], res["shape"], res["n_devices"]),
        hlo_flops_per_dev=res["flops"],
    )


def what_would_help(r: Roofline) -> str:
    """One sentence for the dominant term, on the card."""
    b = r.bottleneck
    if b == "collective":
        return ("reduce collective volume: fp8 all-to-all payloads, fewer "
                "all-reduces per layer (fuse the psums of a block), or move "
                "traffic onto the NVLink domain instead of the scale-out NICs")
    if b == "memory":
        return ("cut HBM traffic: fused kernels (one pass over the activations "
                "instead of one per eager op), fewer recomputes, fp8 weights, "
                "a paged or compressed KV cache")
    return ("raise tensor-core utilization: larger per-rank tiles (less "
            "sharding on the contracted dim), wgmma-sized GEMMs, fewer small "
            "ops, fp8 where the accuracy allows")
