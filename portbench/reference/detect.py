"""How a detector's answers are judged.

The class scores and box regressions the program computed for a checked
image are held against the float64 reference's (``conf_gap``,
``loc_gap``). Its detections are held against the frozen NMS
(``reference/nms.py``) run on those same scores and regressions, on the
same device in the same float32 operations: an exact comparison
(``nms_diff`` counts the images whose boxes, scores or valid flags
differ in any bit).
"""

from __future__ import annotations

import torch

from . import nms
from .classify import row_gap


def judge(kept: dict, ref_out: tuple, ref_mod, cfg: dict) -> dict:
    conf, loc = kept["conf"], kept["loc"]
    p = cfg["task_params"]
    priors = torch.as_tensor(ref_mod.priors(cfg), device=conf.device)
    boxes, scores, valid = nms.decode_nms_batch(
        conf, loc, priors, prob_threshold=p["prob_threshold"],
        iou_threshold=p["iou_threshold"], candidate_size=p["candidate_size"],
        top_k=p["top_k"], center_variance=p["center_variance"],
        size_variance=p["size_variance"])
    want = torch.cat([boxes, scores[..., None], valid[..., None].to(boxes.dtype)], -1)
    got = torch.as_tensor(kept["out"]).to(want.device)
    same = (got == want).reshape(got.shape[0], -1).all(dim=1)
    return {"conf_gap": row_gap(conf, ref_out[0]), "loc_gap": row_gap(loc, ref_out[1]),
            "nms_diff": int((~same).sum())}
