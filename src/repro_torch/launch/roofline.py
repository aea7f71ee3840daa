"""Roofline terms of a dry-run cell (the port of ``repro.launch.roofline``).

Three terms per (arch × shape × mesh) cell, in seconds per step on the
target card, derived from the per-device counts of ``launch.cost`` (the dry
run runs on the CPU over a fake mesh, so never from wall time):

    compute    = FLOPs_per_device / PEAK_FLOPS
    memory     = bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / LINK_BW

The reference's ``parse_collectives`` reads the collectives out of XLA's HLO
text; the port has no HLO, and ``launch.cost`` counts the collectives as
DTensor issues them, so it is not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

# ---- hardware constants: one NVIDIA H100 SXM5 80GB, NVIDIA's H100 data
# sheet (dense rates, no sparsity, at the 700 W limit) ----------------------
PEAK_FLOPS = 989e12          # bf16 FLOP/s, tensor cores, dense
HBM_BW = 3.35e12             # bytes/s, HBM3
LINK_BW = 450e9              # bytes/s, NVLink 4, each direction


def _leaves_with_path(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, path + (k,))
    else:
        yield path, tree


# --------------------------------------------------------------------------- #
# MODEL_FLOPS (the "useful work" yardstick)                                    #
# --------------------------------------------------------------------------- #
def active_param_count(bb) -> Tuple[int, int]:
    """(N_active_nonembed, N_total) from the parameter tree.

    MoE expert leaves are scaled by top_k/n_experts for the active count.
    Embedding table excluded from N_active (a gather, not a matmul); the
    LM head term is added separately by model_flops().
    """
    cfg = bb.cfg
    n_active = 0
    n_total = 0
    moe_frac = (cfg.top_k / cfg.n_experts) if cfg.n_experts else 1.0
    for names, leaf in _leaves_with_path(bb.init(device="meta")):
        size = 1
        for d in leaf.shape:
            size *= d
        n_total += size
        if "embed" in names or names[-1] == "lm_head":
            continue
        if cfg.ffn_kind == "moe" and len(leaf.shape) == 4 \
                and names[-1] in ("w_gate", "w_up", "w_down"):
            n_active += int(size * moe_frac)
        else:
            n_active += size
    return n_active, n_total


def model_flops(bb, shape_kind: str, tokens: int) -> float:
    """6·N_active·tokens (train) or 2·N_active·tokens (serve), plus the
    LM-head matmul term 6/2·tokens·d·V."""
    n_active, _ = active_param_count(bb)
    head = bb.cfg.d_model * bb.plan.eff_vocab(bb.cfg)
    mult = 6.0 if shape_kind == "train" else 2.0
    return mult * tokens * (n_active + head)


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float          # global useful FLOPs per step
    hlo_flops: float            # per-device counted FLOPs
    useful_ratio: float         # (model_flops / chips) / hlo_flops
    n_chips: int = 1

    @property
    def dominant(self) -> str:
        vals = {"compute": self.compute_s, "memory": self.memory_s,
                "collective": self.collective_s}
        return max(vals, key=vals.get)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time over the binding term: time the chip would
        spend on MODEL_FLOPS at peak, divided by the dominant-term time."""
        useful_s = self.model_flops / self.n_chips / PEAK_FLOPS
        bound = max(self.compute_s, self.memory_s, self.collective_s)
        return useful_s / bound if bound > 0 else 0.0

    def to_json(self) -> Dict[str, Any]:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "hlo_flops": self.hlo_flops,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def derive_terms(cost: Dict[str, float], collective_bytes: float,
                 mflops: float, n_chips: int) -> RooflineTerms:
    """Terms from a per-device ``{"flops", "bytes accessed"}`` dict and the
    per-device collective bytes."""
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes accessed", 0.0))
    per_chip_useful = mflops / n_chips
    return RooflineTerms(
        compute_s=flops / PEAK_FLOPS,
        memory_s=nbytes / HBM_BW,
        collective_s=collective_bytes / LINK_BW,
        model_flops=mflops,
        hlo_flops=flops,
        useful_ratio=(per_chip_useful / flops) if flops else 0.0,
        n_chips=n_chips,
    )


def derive_terms_from_totals(totals, mflops: float, n_chips: int
                             ) -> RooflineTerms:
    """Terms from the counted ``launch.cost.CostTotals`` of one rank."""
    return derive_terms({"flops": totals.flops,
                         "bytes accessed": totals.bytes},
                        totals.collective_bytes, mflops, n_chips)
