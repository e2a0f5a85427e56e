"""An SSD detector's step: the fused int8 forward (class scores through the
graph's softmax, box regressions), then the port's device decode and
per-class NMS, packed into one row per image: ``[classes - 1, top_k, 6]``
of box corners, score and a valid flag."""

from __future__ import annotations

import time

import torch

from portbench.trace import NMS_SPAN


class Task:
    def __init__(self, net, cfg: dict, device):
        from dfq_tpu_torch.detection.device_nms import decode_nms_batch
        from dfq_tpu_torch.models.ssd import quantized_priors

        from portbench.program import load

        self.net = net
        self.nms = decode_nms_batch
        p = cfg["task_params"]
        self.kw = {k: p[k] for k in ("prob_threshold", "iou_threshold", "candidate_size",
                                     "top_k", "center_variance", "size_variance")}
        ssd_cfg = load(cfg["program"]["ssd_config"])(image_size=cfg["image_size"])
        self.priors = torch.as_tensor(quantized_priors(ssd_cfg), device=device)
        self.sync = torch.device(device).type == "cuda"

    def step(self, x, spans=None):
        """As :meth:`classify.Task.step`; the checked tensors are the
        scores and regressions. The NMS call is marked for the profiler
        (``portbench.nms``); with ``spans`` (a list) it is also timed
        between two synchronisations and its seconds appended."""
        conf, loc = self.net(x)
        if spans is not None and self.sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.record_function(NMS_SPAN):
            boxes, scores, valid = self.nms(conf, loc, self.priors, **self.kw)
        if spans is not None:
            if self.sync:
                torch.cuda.synchronize()
            spans.append(time.perf_counter() - t0)
        rows = torch.cat([boxes, scores[..., None], valid[..., None].to(boxes.dtype)], -1)
        return rows, {"conf": conf, "loc": loc}
