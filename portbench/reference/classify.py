"""How a classifier's answers are judged: each checked row of logits
against the float64 reference's row for the same image."""

from __future__ import annotations

import torch


def row_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest ``||got - ref|| / ||ref||`` over rows (flattened)."""
    got = got.reshape(got.shape[0], -1).to(ref.device, torch.float64)
    ref = ref.reshape(ref.shape[0], -1)
    return float(((got - ref).norm(dim=1) / ref.norm(dim=1).clamp_min(1e-30)).max())


def judge(kept: dict, ref_out: tuple, ref_mod, cfg: dict) -> dict:
    return {"logit_gap": row_gap(kept["out"], ref_out[0])}
