"""What the port's entry points share: the reference's DFQ flags and the
forward of the chosen engine (``sim``: the f32 fake-quant simulator;
``int8``: the baseline int8 engine ``Int8Net``; ``fused``:
``Int8FusedNet`` on the hand-written kernels), with the int8 artifact
saved on request."""

from __future__ import annotations

import argparse


def add_dfq_flags(p: argparse.ArgumentParser) -> None:
    """The reference's quantization flags (``main_cls.py:23-41``,
    ``main_seg.py``, ``main_ssd.py``) and the port's ``--device``,
    ``--engine`` and ``--save-artifact``."""
    for flag in ("--quantize", "--equalize", "--distill_range", "--correction",
                 "--absorption", "--relu", "--clip_weight", "--log"):
        p.add_argument(flag, action="store_true")
    p.add_argument("--bits_weight", type=int, default=8)
    p.add_argument("--bits_activation", type=int, default=8)
    p.add_argument("--bits_bias", type=int, default=8)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda, or cpu for the kernels' plain versions)")
    p.add_argument("--engine", choices=["sim", "int8", "fused"], default="sim",
                   help="fake-quant simulation or true-int8 execution")
    p.add_argument("--save-artifact", type=str, default=None,
                   help="write the lowered int8 model as an artifact directory")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="torch state_dict (.pth) to load")


def distill_config(args, device, **overrides):
    """The entry point's ``DistillConfig``: ``--dis_batch_size`` batches of
    ``--dis_num_batch`` on ``device``, with the workload's ``overrides``
    (image size, value range, early-break factor)."""
    from dfq_tpu_torch.calib import DistillConfig

    return DistillConfig(batch_size=args.dis_batch_size, num_batch=args.dis_num_batch,
                         device=str(device), **overrides)


def engine_forward(prep, cfg, engine: str, device, save_artifact=None):
    """The forward of ``engine`` on ``device`` (the simulator unless
    ``engine`` is ``int8`` or ``fused`` and the model is quantized), and
    for the int8 engines ``{"model": lowered, "params": residual f32}``."""
    from dfq_tpu_torch.engine import Int8FusedNet, Int8Net, lower_int8
    from dfq_tpu_torch.graph import execute
    from dfq_tpu_torch.graph.executor import params_to

    if engine in ("int8", "fused") and cfg.quantize:
        if cfg.trainable:
            raise SystemExit("--trainable is a fake-quant regime; use --engine sim")
        model = lower_int8(prep)
        residual = {k: v for k, v in prep.params.items() if k not in model.layers}
        if engine == "fused":
            fwd = Int8FusedNet(model, device=device, params_f32=residual)
        else:
            fwd = Int8Net(model, residual, device=device)
        if save_artifact:
            from dfq_tpu_torch.io import save_artifact as save

            save(save_artifact, model, residual)
            print(f"artifact saved to {save_artifact}")
        return fwd, {"model": model, "params": residual}
    wb = cfg.bits_weight if (cfg.trainable and cfg.quantize) else None
    sim_params = params_to(prep.params, device)

    def fwd(x):
        return execute(prep.graph, sim_params, x, act_ranges=prep.act_ranges,
                       bits_act=cfg.bits_activation, weight_bits=wb,
                       bias_bits=cfg.bits_bias, device=device)

    return fwd, {}


def load_checkpoint(graph, path: str):
    """A torch checkpoint (a state dict, a module, or a dict holding
    ``state_dict``) as the graph's params."""
    import torch

    from dfq_tpu_torch.models import load_torch_state_dict

    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return load_torch_state_dict(graph, sd)
