"""ZeroQ-style distilled-data synthesis (port of ``dfq_tpu/calib/distill.py``).

Behavioral contract: the reference's ``getDistilData``
(``ZeroQ/distill_data.py:75-227``):

- seed batches uniform: ``((randint(0,255) - 127)/128) * max_value``,
  drawn by numpy from the seed, so the port's seed batches are the JAX
  package's;
- loss = sum over BN layers of ``|mu_BN - mu_batch|^2/C +
  |sigma_BN - sigma_batch|^2/C`` (per-sample statistics of the BN input)
  plus the input-image statistics loss against N(0,1) normalized by batch
  size;
- Adam lr 0.1 with ReduceLROnPlateau (patience 100, factor 0.1,
  min_lr 1e-7);
- input clamped to ``value_range`` inside the forward;
- early break when ``loss <= (num_BN + 1) * early_break_factor``.

The JAX package runs each batch's optimization as one ``lax.while_loop``.
Here it is a host loop on one device: the gradient by ``torch.autograd``
through the simulator (:func:`~dfq_tpu_torch.graph.executor.execute`,
``capture="bn_inputs"``), then the Adam and plateau step of the same form
(:func:`adam_step`, :class:`Plateau`). Each step reads the loss on the host
once, for the plateau bookkeeping and the break test; that is its one
synchronisation with the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from dfq_tpu_torch.device import resolve_device
from dfq_tpu_torch.graph.executor import execute, highest_precision, params_to
from dfq_tpu_torch.graph.ir import Graph


@dataclasses.dataclass
class DistillConfig:
    batch_size: int = 64
    num_batch: int = 8
    image_size: Tuple[int, int] = (224, 224)
    value_range: Tuple[float, float] = (-2.11790393, 2.64)
    max_value: float = 3.0
    early_break_factor: float = 1.0
    max_iters: int = 1000
    lr: float = 0.1
    plateau_patience: int = 100
    plateau_factor: float = 0.1
    min_lr: float = 1e-7
    # "bf16" (the default, as in the JAX package) runs the network's
    # forward and backward in bfloat16; the images, the Adam state, the BN
    # statistics and the loss stay f32. "f32" is the reference-precision
    # synthesis (TF32 off), which the parity tests use.
    compute_dtype: str = "bf16"
    device: Optional[str] = None  # None: CUDA


def _bn_targets(graph: Graph, params) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Per-BN (mean, std) targets: raw statistics for unfolded BNs, the
    retained ``stat_mean``/``stat_std`` for folded ones."""
    targets = {}
    for node in graph:
        if node.op != "bn":
            continue
        p = params[node.name]
        if "stat_std" in p:
            targets[node.name] = (np.asarray(p["stat_mean"], np.float32),
                                  np.asarray(p["stat_std"], np.float32))
        else:
            targets[node.name] = (np.asarray(p["mean"], np.float32),
                                  np.sqrt(np.asarray(p["var"], np.float32) + 1e-6))
    return targets


def init_random_batch(rng: np.random.Generator, cfg) -> np.ndarray:
    h, w = cfg.image_size
    raw = rng.integers(0, 255, size=(cfg.batch_size, h, w, 3)).astype(np.float32)
    return ((raw - 127.0) / 128.0) * cfg.max_value


def bn_statistics_loss(graph: Graph, params, targets, *, clamp=None, dtype=torch.float32,
                       device=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """``x -> loss``: the BN-statistics loss of the network run on ``x``
    (clamped to ``clamp`` first, if given, and cast to ``dtype``) plus the
    input-statistics loss of ``x`` itself, in f32. The BN terms sum
    per-sample statistics; the input term divides by the batch size, which
    ``loss_fn(x, batch_size=B)`` sets to a whole batch's when ``x`` is one
    shard of it (``parallel/calib.py``): the shards' losses then add up to
    the whole batch's."""
    dev = resolve_device(device)
    params_c = params_to(params, dev, dtype)
    tgt = {k: (torch.as_tensor(m, device=dev), torch.as_tensor(s, device=dev))
           for k, (m, s) in targets.items()}

    def loss_fn(x: torch.Tensor, batch_size: Optional[int] = None) -> torch.Tensor:
        xc = x if clamp is None else torch.clamp(x, clamp[0], clamp[1])
        # the statistics are computed in f32 either way (the executor casts)
        _, aux = execute(graph, params_c, xc.to(dtype), capture="bn_inputs", device=dev)
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for name, (mu_t, sd_t) in tgt.items():
            mean_b, std_b = aux[name]  # [B, C] each
            c = mu_t.shape[0]
            loss = loss + torch.sum((mean_b - mu_t) ** 2) / c
            loss = loss + torch.sum((std_b - sd_t) ** 2) / c
        # input statistics vs N(0, 1), normalized by batch size
        flat = x.reshape(x.shape[0], -1, 3)
        n_el = flat.shape[1]
        mu_x = flat.mean(dim=1)
        sd_x = torch.sqrt(flat.var(dim=1, correction=0) * (n_el / (n_el - 1)))
        b = x.shape[0] if batch_size is None else batch_size
        return loss + torch.sum(mu_x**2) / b + torch.sum((sd_x - 1.0) ** 2) / b

    return loss_fn


def make_loss_fn(graph: Graph, params, cfg: DistillConfig):
    """``(loss_fn, number of BN targets)``, as the JAX package's."""
    targets = _bn_targets(graph, params)
    dtype = torch.bfloat16 if cfg.compute_dtype == "bf16" else torch.float32
    return bn_statistics_loss(graph, params, targets, clamp=cfg.value_range, dtype=dtype,
                              device=cfg.device), len(targets)


def loss_and_grad(loss_fn, x: torch.Tensor):
    """``(loss, d loss / d x)`` at ``x``, the forward and the backward both
    in full f32 on CUDA (TF32 off in cuDNN and cuBLAS: the backward's convs
    run after the forward's ``highest_precision`` has exited)."""
    x = x.detach().requires_grad_(True)
    with highest_precision():
        loss = loss_fn(x)
        (grad,) = torch.autograd.grad(loss, x)
    return loss.detach(), grad


@dataclasses.dataclass
class AdamState:
    """optax ``adam`` state with its learning rate (f32). ``injected``:
    the state of ``inject_hyperparams(adam)``, whose hyperparameters are
    f32 numbers; else of plain ``adam(lr)``, whose ``b1``, ``b2`` stay
    Python floats (``parallel/calib.py``, as the JAX package's sharded
    step)."""

    mu: torch.Tensor
    nu: torch.Tensor
    count: int
    lr: float
    injected: bool = True

    @classmethod
    def init(cls, x: torch.Tensor, lr: float, injected: bool = True) -> "AdamState":
        return cls(torch.zeros_like(x), torch.zeros_like(x), 0, float(np.float32(lr)),
                   injected)


def adam_step(x: torch.Tensor, grad: torch.Tensor, st: AdamState, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-8) -> torch.Tensor:
    """One step of optax's ``adam`` (``eps_root`` 0) in its float form:
    ``mu <- (1-b1) g + b1 mu``, ``nu <- (1-b2) g^2 + b2 nu``, and ``x - lr *
    (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)``; the moments are
    updated in place. Returns the new ``x``. ``1 - b1`` is computed in f32
    for the injected state's f32 hyperparameters, and in Python's float64,
    then rounded to f32, for plain ``adam``'s."""
    one_minus = ((lambda b: float(np.float32(1) - np.float32(b))) if st.injected
                 else (lambda b: float(np.float32(1.0 - b))))
    c1, c2 = one_minus(b1), one_minus(b2)
    b1, b2 = np.float32(b1), np.float32(b2)
    st.count += 1
    st.mu.mul_(float(b1)).add_(grad * c1)
    st.nu.mul_(float(b2)).add_(grad * grad * c2)
    t = torch.tensor(float(st.count), dtype=torch.float32)
    bc1 = float(1.0 - torch.tensor(float(b1), dtype=torch.float32) ** t)
    bc2 = float(1.0 - torch.tensor(float(b2), dtype=torch.float32) ** t)
    upd = (st.mu / bc1) / (torch.sqrt(st.nu / bc2) + float(np.float32(eps)))
    return x + upd * -st.lr


@dataclasses.dataclass
class Plateau:
    """ReduceLROnPlateau bookkeeping on f32 host numbers (relative
    threshold 1e-4, torch's default), as the JAX loop's body."""

    patience: int
    factor: float
    min_lr: float
    best: np.float32 = np.float32(np.inf)
    bad: int = 0

    def step(self, loss: np.float32, lr: float) -> float:
        """Record ``loss``; returns the learning rate for the next step."""
        if loss < self.best * np.float32(1.0 - 1e-4):
            self.best, self.bad = loss, 0
        else:
            self.bad += 1
        if self.bad > self.patience:
            self.bad = 0
            return float(max(np.float32(lr) * np.float32(self.factor), np.float32(self.min_lr)))
        return lr


def optimize_batch(loss_fn, x0, *, lr: float, max_iters: int, threshold: float,
                   patience: int, factor: float, min_lr: float, device=None):
    """Adam with the plateau schedule on ``loss_fn`` from ``x0`` until the
    last loss is at most ``threshold`` or ``max_iters`` steps ran:
    ``(x, steps, last loss)`` with ``x`` on the device."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(x0) if not isinstance(x0, torch.Tensor) else x0,
                        dtype=torch.float32).to(dev)
    st = AdamState.init(x, lr)
    plateau = Plateau(patience, factor, min_lr)
    thr = np.float32(threshold)
    it, last = 0, np.float32(np.inf)
    while it < max_iters and last > thr:
        loss, grad = loss_and_grad(loss_fn, x)
        with torch.no_grad():
            x = adam_step(x, grad, st)
        last = np.float32(loss.item())
        st.lr = plateau.step(last, st.lr)
        it += 1
    return x.detach(), it, float(last)


def distill_batch_fn(graph: Graph, params, cfg: DistillConfig):
    """The per-batch synthesis ``x0 -> (images, steps, last loss)``: the
    images clipped to ``value_range``, on the device."""
    loss_fn, num_bn = make_loss_fn(graph, params, cfg)
    threshold = (num_bn + 1) * cfg.early_break_factor

    def run(x0):
        x, it, last = optimize_batch(
            loss_fn, x0, lr=cfg.lr, max_iters=cfg.max_iters, threshold=threshold,
            patience=cfg.plateau_patience, factor=cfg.plateau_factor, min_lr=cfg.min_lr,
            device=cfg.device)
        return torch.clamp(x, cfg.value_range[0], cfg.value_range[1]), it, last

    return run


def distill_data(graph: Graph, params, cfg: Optional[DistillConfig] = None, seed: int = 0,
                 verbose: bool = False) -> List[np.ndarray]:
    """Synthesize ``cfg.num_batch`` batches of calibration images (host
    f32 NHWC arrays)."""
    cfg = cfg or DistillConfig()
    rng = np.random.default_rng(seed)
    run = distill_batch_fn(graph, params, cfg)
    batches = []
    for i in range(cfg.num_batch):
        x, it, loss = run(init_random_batch(rng, cfg))
        if verbose:
            print(f"batch {i + 1}/{cfg.num_batch}: iters={it} loss={loss:.3f}")
        batches.append(x.cpu().numpy())
    return batches
