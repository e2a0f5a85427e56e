"""Measure the rates of the operations the kernels' inner loops are made of.

    python3 -m dfq_tpu_torch.tools.pipe_rates

Builds ``pipe_rates.cu`` (beside this file) with ``nvcc`` into
``build/cuda/`` and runs it on GPU 0: thread-operations per clock and SM
for dp4a, integer multiply-add, float multiply-add, int-to-float,
float-to-int, byte permute, integer and float min/max, ``rintf``, and
``mma.sync.m16n8k32`` s8 (warp instructions per clock and SM), at
the card's maximum SM clock as ``nvidia-smi`` reports it (a card that
runs below it under load reads low). The kernels' epilogues are written
from these figures (``csrc/int8_epilogue.cuh``).
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

from dfq_tpu_torch.ops import _build


def main() -> int:
    src = Path(__file__).with_suffix(".cu")
    exe = _build.BUILD_DIR / "pipe_rates"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "--fmad=false", "-o", str(exe), str(src)], check=True, timeout=600)
    smi = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
           "--format=csv,noheader,nounits"]
    name, limit, mhz = (s.strip() for s in subprocess.run(
        smi, check=True, capture_output=True, text=True, timeout=60).stdout.splitlines()[0].split(","))
    print(f"card: {name}, {limit} W, max SM clock {mhz} MHz", flush=True)
    return subprocess.run([str(exe), mhz], timeout=600).returncode


if __name__ == "__main__":
    sys.exit(main())
