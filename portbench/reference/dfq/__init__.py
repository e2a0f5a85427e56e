"""A frozen copy of the port's DFQ graph IR, passes and model graphs.

Copied from ``dfq_tpu_torch`` (``graph/ir.py``, ``passes/``,
``quant/moments.py``, ``models/mobilenet_v2.py``, ``models/ssd.py``, the
numpy half of ``quant/core.py``) when the benchmark was defined, and
``models/resnet.py`` when its configuration was added, with the
imports made relative: the reference works the quantized model out
again with the passes as they stood then, and imports nothing of the
program. A later change to the program's passes does not reach it.
"""
