"""Two processes of the port's multi-process path on the CPU
(``dfq_tpu_torch.parallel.multihost``), as ``tests/test_multihost_2proc.py``
holds the JAX package's: each process joins a ``gloo`` group through
``initialize``, splits a dataset with ``host_shard_bounds``, contributes
its rows to a global batch over its 4-shard mesh (``make_global_batch``)
and reads two reductions over both processes' rows: a sum, and the top-1
counter of ``parallel/eval.py`` (``count_correct``). Both ranks must see
sum 36.0 and 6 correct of 8.

This module is also the worker: run as a script with ``<rank> <nproc>
<port>``, it prints ``RESULT <rank> <sum> <correct> <total>``.
"""

import os
import socket
import subprocess
import sys


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_global_reduction():
    nproc = 2
    port = _free_port()
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), str(rank), str(nproc),
                          str(port)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()

    # every worker observed the same reduction over both processes' rows:
    # sum = (1+2) * 4 rows * 3 cols = 36; correct = 8 - 2 planted wrong
    # rows = 6 of 8
    for rank, out in enumerate(outs):
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT")][-1]
        _, r, total, correct, n = line.split()
        assert int(r) == rank
        assert float(total) == 36.0, line
        assert int(correct) == 6 and int(n) == 8, line


def _worker(rank: int, nproc: int, port: str) -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import numpy as np
    import torch

    from dfq_tpu_torch.parallel.eval import count_correct
    from dfq_tpu_torch.parallel.multihost import (
        global_mesh,
        host_shard_bounds,
        initialize,
        make_global_batch,
        process_count,
    )

    torch.set_num_threads(1)
    initialize(f"localhost:{port}", nproc, rank, device="cpu")
    try:
        assert process_count() == nproc, process_count()
        mesh = global_mesh(["cpu"] * 4)
        assert mesh.size == 4

        # per-process dataset split
        start, end = host_shard_bounds(80)
        assert end - start == 80 // nproc

        # each process contributes distinct rows; the reduction must see both
        local = np.full((4, 3), rank + 1, np.float32)
        arr = make_global_batch(mesh, local)
        assert arr.shape == (4 * nproc, 3)
        got = float(arr.sum())

        # the sharded eval's counter: per-shard argmax, summed across processes
        logits = np.zeros((4, 10), np.float32)
        labels = np.arange(4) + 4 * rank
        logits[np.arange(4), labels % 10] = 1.0
        logits[0] = 0.0  # one wrong row per process: correct = total - nproc
        logits[0, (labels[0] + 1) % 10] = 1.0
        correct, total = count_correct(make_global_batch(mesh, logits),
                                       make_global_batch(mesh, labels % 10)).tolist()
        print(f"RESULT {rank} {got} {correct} {total}", flush=True)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
