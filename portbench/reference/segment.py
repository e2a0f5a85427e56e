"""How a segmenter's answers are judged.

Each checked image's map of logits is held against the float64
reference's as one row (``logit_gap``). Its labels are held against
``argmax`` over the classes of the program's own kept logits, on the same
device: an exact comparison (``label_diff`` counts the images whose
labels differ at any pixel). Where nothing was kept besides the logits
(the control), the labels are their ``argmax``.
"""

from __future__ import annotations

import torch

from .classify import row_gap


def judge(kept: dict, ref_out: tuple, ref_mod, cfg: dict) -> dict:
    out = kept["out"]
    want = out.argmax(-1).to(torch.uint8)
    got = torch.as_tensor(kept.get("labels", want)).to(want.device)
    same = (got == want).reshape(got.shape[0], -1).all(dim=1)
    return {"logit_gap": row_gap(out, ref_out[0]), "label_diff": int((~same).sum())}
