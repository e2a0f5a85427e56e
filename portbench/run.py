"""Run one benchmark cell once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the repository's root. The cell (``BENCHMARK.json``) names a
configuration (``portbench/configs/<config>.json``) and a traffic mix
(``portbench/traffic/<mix>.json``, read by the generator
``portbench/traffic/<kind>.py``); its metrics are read by
``portbench/end_to_end/<metric>.py`` (``--trace 0``) and
``portbench/layer_metrics/<metric>.py`` (``--trace 1``). The run sets the
port up from the seed, warms the cell's shapes, measures for
``--seconds``, then holds what the timed path produced against the plain
reference (``portbench/reference/``) and prints the numbers compared,
each beside its limit, as the last lines on standard error. The last line
on standard output is the result's JSON.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "dfq_tpu"}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reader(kind: str, name: str):
    """``portbench/<kind>/<name>.py``'s ``read`` (names may hold dots)."""
    path = ROOT / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: dict, trace: bool) -> list:
    """The metric entries this cell reports: its end-to-end metrics, or with
    ``trace`` its per-layer ones."""
    e2e = [m for m in bench["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    if not trace:
        return e2e
    moves = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell["name"] in m.get("workloads", [cell["name"]] if m["moves"] in moves else [])]


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


class Cell:
    """What a traffic generator needs of the run."""

    def __init__(self, cfg, mix, seed, seconds, trace, device, program, gen):
        self.cfg, self.mix, self.seed, self.seconds = cfg, mix, seed, seconds
        self.trace, self.device, self.program, self.gen = trace, device, program, gen
        self.cuda = torch.device(device).type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()


class Setup:
    """A cell set up for its window: configuration, mix, seeded parameters,
    the program and the traffic generator with its inputs warmed."""

    def __init__(self, bench: dict, name: str, seed: int, seconds: float, trace: bool,
                 device: str, overrides: dict = None, plain_kernels: bool = False):
        from portbench import program as program_mod
        from portbench import seeded

        self.cell = next(w for w in bench["workloads"] if w["name"] == name)
        cfg = load_json(ROOT / "configs" / f"{self.cell['config']}.json")
        cfg.update({k: v for k, v in (overrides or {}).items() if k != "mix"})
        mix = load_json(ROOT / "traffic" / f"{self.cell['traffic']}.json")
        mix.update((overrides or {}).get("mix", {}))
        self.cfg, self.mix, self.device = cfg, mix, device
        self.cuda = torch.device(device).type == "cuda"
        self.ref_mod = importlib.import_module(f"portbench.reference.{cfg['name']}")
        self.ref_graph = self.ref_mod.graph(cfg)
        gen = seeded.generator(seed, device)
        self.params = seeded.make_params(self.ref_graph, gen)
        self.prog = program_mod.Program(cfg, self.params, device, plain_kernels=plain_kernels)
        c = Cell(cfg, mix, seed, seconds, trace, device, self.prog, gen)
        t = time.perf_counter()
        kind = importlib.import_module(f"portbench.traffic.{mix['kind']}")
        self.traffic = kind.Traffic(c)
        self.prog.split["inputs_and_warmup"] = time.perf_counter() - t
        self.batch = mix.get("batch", max(mix.get("buckets", [1])))
        self.sites = self.prog.kernel_sites(self.batch)
        if trace:
            from portbench.trace import Stretch

            Stretch().warm()


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool, device: str,
             t0: float, overrides: dict = None, plain_kernels: bool = False) -> dict:
    """One run of cell ``name``; returns the result (its ``check`` last).
    ``overrides`` updates the configuration and, under ``"mix"``, the
    traffic mix (a test's smaller sizes)."""
    from portbench.reference import costs

    s = Setup(bench, name, seed, seconds, trace, device, overrides, plain_kernels)
    cell, cfg, mix, cuda = s.cell, s.cfg, s.mix, s.cuda
    ref_mod, ref_graph, params, batch, sites = s.ref_mod, s.ref_graph, s.params, s.batch, s.sites
    traffic = s.traffic
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0
    log("setup split (s): " + json.dumps({k: round(v, 4) for k, v in s.prog.split.items()}))

    launches = s.prog.launches()
    rec = traffic.run()
    rec["launches"] = {k: v - launches[k] for k, v in s.prog.launches().items()}
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"portbench: forbidden modules loaded in this process: {bad}")
    rec.update(setup_s=setup_s, window_peak_bytes=window_peak)

    # the check: what the timed path produced, against the reference
    checks = {}
    try:
        kept, images, numbers = traffic.checked()
    except RuntimeError as e:
        log(f"check: {e}")
        kept, numbers = None, {}
    traffic.close()
    del traffic, s
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    if kept is not None:
        numbers.update(reference_judge(ref_mod, ref_graph, cfg, params, kept, images, device))
    log(f"reference: {time.perf_counter() - t:.3f} s on {len(images) if kept is not None else 0} "
        f"images")
    limits = {**cfg["limits"], **mix.get("limits", {})}
    for k, v in numbers.items():
        checks[k] = {"value": v, "limit": limits[k]}
    correct = (kept is not None and rec["failed"] == 0 and set(checks) == set(limits)
               and all(c["value"] <= c["limit"] for c in checks.values()))

    # metrics
    metrics = {}
    dev_name = torch.cuda.get_device_name(0) if cuda else "cpu"
    t_ctx = dict(rec)
    site_costs = [costs.site_cost(ref_graph, cfg["image_size"], batch, n, k) for n, k in sites]
    pk = costs.peaks(dev_name)
    t_ctx.update(
        peaks=pk, ops_per_image=costs.model_ops_per_image(ref_graph, cfg["image_size"]),
        sites_per_step={k: sum(1 for _, kk in sites if kk == k)
                        for k in ("matmul_int8_requant", "dw3x3_int8_requant",
                                  "fused_block_int8")},
        kernel_bound_s_per_step=sum(costs.site_bound_s(sc, pk) for sc in site_costs) if pk else 0)
    for m in cell_metrics(bench, cell, trace):
        kind = "layer_metrics" if trace else "end_to_end"
        v = reader(kind, m["name"])(t_ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        else:
            log(f"metric {m['name']}: nothing to read")
    describe(rec, t_ctx)

    out = {"correct": bool(correct), "attempted": int(rec["attempted"]),
           "failed": int(rec["failed"]), "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu", "kind": dev_name,
                      "count": cell["chips"] if cuda else 0,
                      "memory_peak_bytes": int(max(setup_peak, window_peak))}}
    st = rec.get("stretch")
    if trace and st:
        out["device"].update(busy_s=st["busy_s"], window_s=st["window_s"])
        out["breakdown"] = {"device_ops": [[n[:120], s] for n, s, _ in st["device_ops"][:10]],
                            "idle_gaps": [[n[:120], s] for n, s in st["gaps"][:10]]}
    out["check"] = checks
    return out


def reference_judge(ref_mod, ref_graph, cfg, params, kept, images, device) -> dict:
    """Work the quantized model out again from the same float parameters,
    run it over the checked images in blocks, and judge the kept rows."""
    from portbench.reference import int8_model
    from portbench.reference.dfq.prepare import QuantConfig, prepare

    prep = prepare(ref_graph, params, QuantConfig(**cfg["quant"]))
    ref = int8_model.Reference(int8_model.lower(prep, cfg["quant"]["bits_weight"]), device)
    outs = [ref(images[i:i + 32]) for i in range(0, len(images), 32)]
    ref_out = tuple(torch.cat([o[j] for o in outs]) for j in range(len(outs[0])))
    judge = importlib.import_module(f"portbench.reference.{cfg['task']}").judge
    return judge(kept, ref_out, ref_mod, cfg)


def describe(rec: dict, t: dict) -> None:
    """Earlier lines: what the window did, beside the metrics."""
    info = {"window_s": rec["window_s"], "attempted": rec["attempted"], "failed": rec["failed"],
            "kernel_sites_per_step": t["sites_per_step"], "kernel_launches": rec["launches"]}
    if rec.get("latencies_s") is not None:
        lat, late = rec["latencies_s"], rec["lateness_s"]
        info.update(latency_samples=len(lat), offered_per_s=rec["offered_per_s"],
                    completed_in_window=rec["completed_in_window"],
                    latency_ms={"p50": float(np.percentile(lat, 50)) * 1e3,
                                "p95": float(np.percentile(lat, 95)) * 1e3} if len(lat) else None,
                    generator_lateness_ms={"p50": float(np.percentile(late, 50)) * 1e3,
                                           "p99": float(np.percentile(late, 99)) * 1e3,
                                           "max": float(late.max()) * 1e3},
                    batcher=rec["batcher"], dispatch_sizes=rec["dispatch_sizes"],
                    requests_beyond_p95=int(np.sum(lat > np.percentile(lat, 95))) if len(lat) else 0)
    else:
        info.update(steps=rec["steps"], images=rec["images"])
    if rec.get("stretch"):
        st = rec["stretch"]
        info.update(stretch={"window_s": st["window_s"], "busy_s": st["busy_s"],
                             "kernels": st["kernels"], "nms_calls": st["nms_calls"]})
    log("window: " + json.dumps(info, default=float))


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT.parent / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        log(f"portbench: no cell {args.workload!r} in BENCHMARK.json")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"portbench: the cell needs {cell['chips']} CUDA card(s); this process sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    log(f"card: {power_limit()}")
    out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    for k, c in out["check"].items():
        log(f"check {k}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
