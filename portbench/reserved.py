"""One run of a cell as ``portbench.run`` makes it, and one more line on
stderr: the most device memory the caching allocator reserved over the
measured window (``torch.cuda.max_memory_reserved``, from the peak reset
at the window's start) and what it reserves at the window's end.

``peak_mem_gib`` reads the bytes tensors hold (``max_memory_allocated``);
a CUDA graph's memory pool keeps its blocks reserved while no tensor
holds them, so the reserved bytes are what the card gives the program.

    python3 -m portbench.reserved --workload <cell> --seed <n> --seconds <s> --trace 0
"""

import sys

import torch

from portbench import run
from portbench.traffic import closed_batch

_run = closed_batch.Traffic.run


def _run_and_read(self) -> dict:
    rec = _run(self)
    print(f"window max_memory_reserved_bytes {torch.cuda.max_memory_reserved()} "
          f"memory_reserved_bytes {torch.cuda.memory_reserved()}", file=sys.stderr, flush=True)
    return rec


if __name__ == "__main__":
    closed_batch.Traffic.run = _run_and_read  # the closed-loop cells' window
    sys.exit(run.main(sys.argv[1:]))
