"""The served cells that ``BENCHMARK.json`` does not hold yet (their rate
served spread too widely between runs for a bound; see PERF.md): the
tests still drive their path through ``MicroBatcher``."""

import json

SERVED = [
    {"name": "mnv2_224.served_poisson", "config": "mobilenet_v2_224",
     "traffic": "poisson_mnv2_224", "chips": 1, "why": "open loop through MicroBatcher"},
    {"name": "ssdlite_300.served_poisson", "config": "ssdlite_mobilenet_v2_300",
     "traffic": "poisson_ssdlite_300", "chips": 1, "why": "open loop through MicroBatcher"},
]


def with_served(bench: dict) -> dict:
    """A copy of ``bench`` with the served cells and their end-to-end
    metric added."""
    bench = json.loads(json.dumps(bench))
    bench["workloads"] += SERVED
    bench["end_to_end"].append({"name": "requests_per_s", "unit": "requests/s",
                                "better": "higher", "bound": 0.25, "source": "host_clock",
                                "workloads": [w["name"] for w in SERVED]})
    layers = {"batch_fill.served": ("program_counter", "serve: MicroBatcher"),
              "dispatch_ms.served": ("host_clock", "engine step under the batcher"),
              "device_idle_share.served": ("device_trace", "device")}
    for name, (source, layer) in layers.items():
        bench["per_layer"].append({
            "name": name, "unit": "ms" if "_ms" in name else "%",
            "better": "lower" if "_ms" in name or "idle" in name else "higher",
            "source": source, "layer": layer, "moves": "requests_per_s",
            "workloads": [w["name"] for w in SERVED]})
    return bench
