"""Weights, BatchNorm statistics and images made from the run's seed.

Both sides get the same arrays: the program through its own graph (whose
layer names and shapes are checked against these first), the reference
through its frozen one. The draws are made on the run's device with one
``torch.Generator`` in a few large calls: one standard normal draw for
every float parameter, then one draw of 8-bit pixels per image set.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

Params = Dict[str, Dict[str, np.ndarray]]


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed) % 2**63)
    return g


def param_specs(graph) -> List[Tuple[str, str, tuple, str]]:
    """``(layer, key, shape, law)`` of every parameter the graph holds,
    with the laws of the DFQ reference's initialisation (conv weights
    normal with std sqrt(2 / (k*k*out)), linear weights std 0.01, biases
    zero) and random BatchNorm statistics (gamma and var lognormal(0,
    0.5), beta normal(0, 0.5), mean normal(0, 0.2))."""
    specs = []
    for node in graph:
        a = node.attrs
        if node.op == "conv":
            kh, kw = a["kernel"]
            specs.append((node.name, "weight", (a["out_ch"], a["in_ch"] // a["groups"], kh, kw),
                          f"normal:{np.sqrt(2.0 / (kh * kw * a['out_ch']))}"))
            if a.get("bias"):
                specs.append((node.name, "bias", (a["out_ch"],), "zero"))
        elif node.op == "linear":
            specs.append((node.name, "weight", (a["out_f"], a["in_f"]), "normal:0.01"))
            if a.get("bias"):
                specs.append((node.name, "bias", (a["out_f"],), "zero"))
        elif node.op == "bn":
            c = (a["ch"],)
            specs += [(node.name, "gamma", c, "lognormal:0.5"), (node.name, "beta", c, "normal:0.5"),
                      (node.name, "mean", c, "normal:0.2"), (node.name, "var", c, "lognormal:0.5")]
        elif node.op not in ("input", "relu", "relu6", "add", "global_mean", "reshape",
                             "concat", "softmax", "identity", "dropout", "maxpool", "pad",
                             "interpolate", "global_pool"):
            raise NotImplementedError(f"no seeded parameters for op {node.op!r} ({node.name})")
    return specs


def make_params(graph, g: torch.Generator) -> Params:
    specs = param_specs(graph)
    n = sum(int(np.prod(s)) for _, _, s, law in specs if law != "zero")
    z = torch.randn(n, generator=g, device=g.device, dtype=torch.float32).cpu().numpy()
    out: Params = {}
    at = 0
    for name, key, shape, law in specs:
        if law == "zero":
            v = np.zeros(shape, np.float32)
        else:
            k = int(np.prod(shape))
            kind, s = law.split(":")
            v = z[at:at + k].reshape(shape) * np.float32(s)
            v = (np.exp(v) if kind == "lognormal" else v).astype(np.float32)
            at += k
        out.setdefault(name, {})[key] = v
    return out


def check_against(program_graph, params: Params) -> None:
    """Raise unless the program's graph holds exactly these layers, with
    these parameter names and shapes."""
    want = {(n, k): s for n, k, s, _ in param_specs(program_graph)}
    have = {(n, k): tuple(v.shape) for n, p in params.items() for k, v in p.items()}
    if want != have:
        missing = sorted(set(want) - set(have))[:5]
        extra = sorted(set(have) - set(want))[:5]
        wrong = sorted(k for k in set(want) & set(have) if want[k] != have[k])[:5]
        raise ValueError(f"seeded parameters do not fit the program's graph: missing {missing}, "
                         f"extra {extra}, other shapes {wrong}")


def make_pixels(n: int, cfg: dict, g: torch.Generator) -> torch.Tensor:
    """``n`` NHWC uint8 images of uniform pixels on the generator's device."""
    size = cfg["image_size"]
    return torch.randint(0, 256, (n, size, size, 3), generator=g, device=g.device,
                         dtype=torch.uint8)


def normalize(pix: torch.Tensor, cfg: dict) -> torch.Tensor:
    """8-bit pixels -> the float32 input the configuration's preprocessing
    states, on the pixels' device."""
    mean = torch.tensor(cfg["input"]["mean"], dtype=torch.float32, device=pix.device)
    std = torch.tensor(cfg["input"]["std"], dtype=torch.float32, device=pix.device)
    return (pix.to(torch.float32) - mean) / std


def make_images(n: int, cfg: dict, g: torch.Generator) -> torch.Tensor:
    """``n`` NHWC float32 images on the generator's device: uniform 8-bit
    pixels, normalised."""
    return normalize(make_pixels(n, cfg, g), cfg)
