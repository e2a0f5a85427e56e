"""Open loop: independent users send one image each, on a schedule that does
not wait for the system, through the port's ``MicroBatcher``. A request
carries its image as 8-bit pixels, as a client sends it; the batcher's
``forward_fn`` copies the stacked pixels to the device and normalises
them there before the forward.

Mix parameters (``traffic/<mix>.json``): ``rate_per_s``; ``pool``, the
number of distinct seeded host images requests draw from; the batcher's
``buckets``, ``max_wait_ms`` and ``pipeline_depth``; ``check_dispatches``
and ``check_rows``, how many dispatches of the window are kept for the
check (the first after each of that many seeded instants) and how many
of their rows; ``trace_s``, the length of the traced stretch;
``drain_s``, how long past the window an unanswered request is awaited.

The inter-arrival gaps are the quantiles of an exponential law at the
rate, in an order drawn from the seed: every seed offers the same number
of requests and the same gaps. Each request is timed from when it was
due, so a late generator shows as latency, and the generator's own
lateness is reported.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from portbench import seeded
from portbench.trace import Stretch


def schedule(rate: float, seconds: float, pool: int, seed: int):
    """``(due seconds, pool index)`` of every request due in the window."""
    n = max(1, int(round(rate * seconds)))
    rng = np.random.default_rng(seed)
    gaps = rng.permutation(-np.log1p(-(np.arange(n) + 0.5) / n) / rate)
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    keep = due < seconds
    return due[keep], rng.integers(0, pool, n)[keep]


class Traffic:
    def __init__(self, cell):
        from dfq_tpu_torch.serve.microbatch import MicroBatcher

        self.cell = cell
        m = cell.mix
        self.pool = list(seeded.make_pixels(m["pool"], cell.cfg, cell.gen).cpu().numpy())
        self.lock = threading.Lock()
        self.rng = np.random.default_rng(cell.seed)
        self.dispatch_s: list = []
        self.kept: list = []
        self.points: list = []
        self.t_start = None
        self.batcher = MicroBatcher(self._forward, (-1, self.pool[0]), buckets=m["buckets"],
                                    max_wait_ms=m["max_wait_ms"],
                                    pipeline_depth=m["pipeline_depth"], stack_fn=self._stack)
        for b in m["buckets"]:  # once more per bucket beyond the batcher's own warm-up
            self._forward(self._stack([(-1, self.pool[0])] * b))
        cell.sync()
        self.dispatch_s.clear()

    @staticmethod
    def _stack(items):
        return [i for i, _ in items], np.stack([x for _, x in items], 0)

    def _forward(self, batch):
        ids, x = batch
        t0 = time.perf_counter()
        with torch.no_grad():
            pix = torch.from_numpy(x).to(self.cell.device)
            out, aux = self.cell.program.task.step(seeded.normalize(pix, self.cell.cfg))
            host = out.cpu()
        dt = time.perf_counter() - t0
        with self.lock:
            self.dispatch_s.append(dt)
            keep = False
            if self.t_start is not None and self.points:
                t = t0 - self.t_start
                while self.points and self.points[0] <= t:
                    self.points.pop(0)
                    keep = True
            if keep:
                n_real = next((k for k in range(1, len(ids)) if ids[k] == ids[0]), len(ids))
                rows = np.sort(self.rng.choice(n_real, min(self.cell.mix["check_rows"], n_real),
                                               replace=False))
        if keep:
            idx = torch.as_tensor(rows, device=out.device)
            kept = {k: v.index_select(0, idx) for k, v in aux.items()}
            with self.lock:
                self.kept.append((list(ids[:n_real]), host, rows, kept))
        return host

    def run(self, rate=None, seconds=None) -> dict:
        cell, m = self.cell, self.cell.mix
        rate = rate or m["rate_per_s"]
        seconds = seconds or cell.seconds
        due, img = schedule(rate, seconds, m["pool"], cell.seed)
        n = len(due)
        futs = [None] * n
        done_at = np.full(n, np.nan)
        lateness = np.zeros(n)
        stretch = Stretch() if cell.trace else None
        trace_at = (seconds / 3, seconds / 3 + m["trace_s"])
        with self.lock:
            self.kept.clear()
            self.dispatch_s.clear()
            self.points = sorted(self.rng.uniform(0, seconds, m["check_dispatches"]).tolist())
        s0 = self.batcher.stats()

        def finish(i):
            def cb(_):
                done_at[i] = time.perf_counter()
            return cb

        start = time.perf_counter() + 0.01
        with self.lock:
            self.t_start = start
        i = 0
        while i < n:
            now = time.perf_counter() - start
            while i < n and due[i] <= now:
                futs[i] = self.batcher.submit((i, self.pool[img[i]]))
                futs[i].add_done_callback(finish(i))
                lateness[i] = time.perf_counter() - start - due[i]
                i += 1
            if stretch is not None:
                if stretch.prof is None and now >= trace_at[0]:
                    stretch.start()
                elif stretch.prof is not None and not stretch.window_s and now >= trace_at[1]:
                    stretch.stop()
            if i < n:
                time.sleep(max(0.0, due[i] - (time.perf_counter() - start)))
        deadline = start + seconds + m["drain_s"]
        for f in futs:
            try:
                f.result(timeout=max(0.0, deadline - time.perf_counter()))
            except Exception:  # late past the drain, or failed: counted below
                pass
        t_wait = time.perf_counter() + 1.0
        while any(f.done() for f in futs) and time.perf_counter() < t_wait and np.isnan(
                done_at[[f.done() and f.exception() is None for f in futs]]).any():
            time.sleep(0.001)  # a done callback still on its way
        if stretch is not None and stretch.prof is not None and not stretch.window_s:
            stretch.stop()
        with self.lock:
            self.t_start = None
        self.futs, self.img = futs, img
        s1 = self.batcher.stats()
        ok = np.array([f.done() and f.exception() is None for f in futs])
        lat = done_at - (start + due)
        return {"attempted": n, "failed": int((~ok).sum()), "images": int(ok.sum()),
                "completed_in_window": int(np.sum(done_at[ok] <= start + seconds)),
                "window_s": seconds, "latencies_s": lat[ok], "due_s": due[ok],
                "lateness_s": lateness,
                "offered_per_s": n / seconds,
                "batcher": {k: getattr(s1, k) - getattr(s0, k)
                            for k in ("dispatches", "items", "padded")},
                "dispatch_sizes": {b: s1.dispatch_sizes.get(b, 0) - s0.dispatch_sizes.get(b, 0)
                                   for b in m["buckets"]},
                "stretch": stretch.summary() if stretch is not None and stretch.prof is not None else None,
                "spans": {"dispatch": list(self.dispatch_s)}}

    def checked(self):
        """``(kept, images, numbers)``: the kept rows of every tensor the
        task checks and their images; ``row_diff``, the requests of the
        kept dispatches whose answer is not their own row of the
        dispatch's output."""
        if not self.kept:
            raise RuntimeError("no dispatch of the window was kept for the check")
        row_diff = 0
        outs, auxes, images = [], [], []
        for ids, host, rows, kept in self.kept:
            for k, rid in enumerate(ids):
                f = self.futs[rid]
                if not (f.done() and f.exception() is None
                        and np.array_equal(np.asarray(f.result()), host[k].numpy())):
                    row_diff += 1
            idx = torch.as_tensor(rows)
            outs.append(host.index_select(0, idx))
            auxes.append(kept)
            images += [self.pool[self.img[ids[r]]] for r in rows]
        kept = {"out": torch.cat(outs)}
        for k in auxes[0]:
            kept[k] = torch.cat([a[k] for a in auxes])
        pix = torch.from_numpy(np.stack(images)).to(self.cell.device)
        return kept, seeded.normalize(pix, self.cell.cfg), {"row_diff": row_diff}

    def close(self) -> None:
        self.batcher.stop()
        self.pool = None
