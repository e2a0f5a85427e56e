"""Closed loop: one caller runs batch after batch, back to back, as an
evaluation pass or a batch job does.

Mix parameters (``traffic/<mix>.json``): ``batch``; ``ring``, the number
of distinct input batches made on the device at set-up and taken in
turn; ``warmup_steps``; ``check_steps`` and ``check_rows``, how many
steps of the window are kept for the check (a reservoir sample drawn
from the seed) and how many rows of each; ``trace_steps``, the length of
the traced stretch, which a traced run follows with as many steps whose
task spans are timed between synchronisations (outside the profiler).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import seeded
from portbench.trace import Stretch


class Traffic:
    def __init__(self, cell):
        self.cell = cell
        m = cell.mix
        self.batch, self.ring_n = m["batch"], m["ring"]
        size = cell.cfg["image_size"]
        self.ring = seeded.make_images(self.ring_n * self.batch, cell.cfg, cell.gen).reshape(
            self.ring_n, self.batch, size, size, 3)
        task = cell.program.task
        with torch.no_grad():
            for i in range(m["warmup_steps"]):
                task.step(self.ring[i % self.ring_n], spans=[] if cell.trace else None)
        cell.sync()
        self.kept = []

    def run(self) -> dict:
        cell, m = self.cell, self.cell.mix
        task = cell.program.task
        rng = np.random.default_rng(cell.seed)
        k_keep, rows_keep = m["check_steps"], m["check_rows"]
        stretch = Stretch() if cell.trace else None
        nms_spans: list = []
        steps = traced = timed = 0
        stretch_images = 0
        cell.sync()
        t0 = time.perf_counter()
        t_end = t0 + cell.seconds
        with torch.no_grad():
            while True:
                slot = steps % self.ring_n
                tracing = stretch is not None and stretch.prof is not None and traced < m["trace_steps"]
                timing = traced == m["trace_steps"] and timed < m["trace_steps"]
                out, aux = task.step(self.ring[slot], spans=nms_spans if timing else None)
                # reservoir sample of the window's steps
                j = steps if steps < k_keep else int(rng.integers(0, steps + 1))
                if j < k_keep:
                    rows = np.sort(rng.choice(self.batch, rows_keep, replace=False))
                    idx = torch.as_tensor(rows, device=out.device)
                    kept = {"out": out.index_select(0, idx)}
                    kept.update({k: v.index_select(0, idx) for k, v in aux.items()})
                    entry = (slot, rows, kept)
                    if len(self.kept) < k_keep:
                        self.kept.append(entry)
                    else:
                        self.kept[j] = entry
                steps += 1
                timed += timing
                if tracing:
                    traced += 1
                    stretch_images += self.batch
                    if traced == m["trace_steps"]:
                        stretch.stop()
                elif (stretch is not None and stretch.prof is None
                      and time.perf_counter() - t0 >= cell.seconds / 4):
                    stretch.start()
                if time.perf_counter() >= t_end:
                    break
        cell.sync()
        window_s = time.perf_counter() - t0
        if stretch is not None and stretch.prof is not None and traced < m["trace_steps"]:
            stretch.stop()
        return {"images": steps * self.batch, "attempted": steps * self.batch, "failed": 0,
                "window_s": window_s, "steps": steps,
                "stretch": stretch.summary() if stretch is not None and stretch.prof is not None else None,
                "stretch_images": stretch_images, "stretch_steps": traced,
                "spans": {"nms": nms_spans}}

    def checked(self):
        """``(kept, images, numbers)``: the kept rows of every tensor the
        task checks, the images they were computed from, and no numbers
        of its own."""
        kept = {k: torch.cat([e[2][k] for e in self.kept]) for k in self.kept[0][2]}
        images = torch.cat([self.ring[slot][torch.as_tensor(rows, device=self.ring.device)]
                            for slot, rows, _ in self.kept])
        return kept, images, {}

    def close(self) -> None:
        self.ring = None
