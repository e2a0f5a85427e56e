"""The closed loop of ``closed_batch``, whose warm-up also makes the
window's reservoir keeps, so the window grows the allocator no more.

After ``closed_batch``'s warm-up, ``warmup_keeps`` more steps each keep
``check_rows`` rows of every checked tensor in one of ``check_steps``
slots, made while the slot's earlier rows are held, as the window makes
them; then all are dropped. Where kept rows are large (a segmenter's
513²×21 maps: 88 MB a keep at 4 rows), the window's keeps then take
blocks the allocator already holds; without this, a process's first
window pays for growing it, and a run's images/s moves with the number
of keeps its seed draws.

Mix parameters: ``closed_batch``'s, and ``warmup_keeps``.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.traffic import closed_batch


class Traffic(closed_batch.Traffic):
    def __init__(self, cell):
        super().__init__(cell)
        m = cell.mix
        task = cell.program.task
        rng = np.random.default_rng(cell.seed)
        held = [None] * m["check_steps"]
        with torch.no_grad():
            for i in range(m["warmup_keeps"]):
                out, aux = task.step(self.ring[i % self.ring_n],
                                     spans=[] if cell.trace else None)
                rows = np.sort(rng.choice(self.batch, m["check_rows"], replace=False))
                idx = torch.as_tensor(rows, device=out.device)
                kept = {"out": out.index_select(0, idx)}
                kept.update({k: v.index_select(0, idx) for k, v in aux.items()})
                held[i % len(held)] = kept
        del held
        cell.sync()
