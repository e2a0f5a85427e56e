"""The zoo's engines on the port against the JAX package, one member of
each kind beside ``tests/test_torch_zoo.py`` (whose helpers this file
uses), with random weights:

- DRN-D-54 DeepLab-v3+ at 65x65 (resizes 9 -> 17 -> 65), the flagship
  config: ``prepare`` and ``lower_int8`` bit-identical;
- MobileNetV1-SSD-Lite (a BN backbone with BN-less extras and heads, which
  the data-free range setter refuses as the reference does): ``--relu``
  with ``distill_range``, then JAX's ``calibrate_ranges`` on one seeded
  batch carried across; ``prepare`` and ``lower_int8`` bit-identical, at
  64x64 (every op of the 300x300 graph at a fraction of its cost);
- for both, ``Int8FusedNet(device="cpu")`` (the kernels' plain versions)
  against JAX's fused engine (Pallas in interpret mode) and ``Int8Net``
  against ``execute_int8``, at the JAX suite's ``atol=1e-4``.
"""

import numpy as np
import torch

from test_torch_zoo import DET, MODELS, _both, _check_engines, _check_prepared

torch.set_num_threads(1)


def test_deeplab_drn_prepare_lower_and_engines():
    cfg = dict(quantize=True, relu=True, equalize=True, absorption=True, correction=True,
               bits_bias=16)
    build = MODELS["deeplab_drn"][0]
    pj, pt = _both(build, cfg)
    mj, _ = _check_prepared(pj, pt)
    x = np.clip(np.random.default_rng(1).normal(0, 1, (1, 65, 65, 3)), -2.117,
                2.64).astype(np.float32)
    _check_engines(pj, mj, x)


def test_mobilenet_v1_ssd_lite_prepare_lower_and_engines():
    cfg = dict(quantize=True, relu=True, bits_bias=16, distill_range=True, **DET)
    rng = np.random.default_rng(3)
    batch = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    pj, pt = _both(lambda m: m.mobilenet_v1_ssd_lite(), cfg, ranges_batch=batch)
    mj, _ = _check_prepared(pj, pt)
    _check_engines(pj, mj, batch)
