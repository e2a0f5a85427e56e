"""Nothing the benchmark loads is JAX or the JAX package, and the reference
loads nothing of the program (top-level module names, compared whole:
``dfq_tpu_torch`` begins with ``dfq_tpu``)."""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "dfq_tpu"}


def _top_level_after(code: str) -> set:
    probe = code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    p = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def _modules(sub: str):
    return [f"portbench.{sub}.{p.stem}" for p in sorted((REPO / "portbench" / sub).glob("*.py"))
            if "." not in p.stem and p.stem != "__init__"]


def test_harness_and_program_load_no_jax():
    mods = (["portbench.run", "portbench.program", "portbench.knee", "portbench.control",
             "portbench.seeded", "portbench.trace"] + _modules("tasks") + _modules("traffic")
            + _modules("reference"))
    code = "\n".join(f"import {m}" for m in mods) + "\n" + "\n".join([
        # what the program side imports when a cell is set up
        "import dfq_tpu_torch.engine, dfq_tpu_torch.pipeline, dfq_tpu_torch.models",
        "import dfq_tpu_torch.models.ssd, dfq_tpu_torch.detection.device_nms",
        "import dfq_tpu_torch.serve.microbatch, dfq_tpu_torch.ops._build",
        "from portbench import run",
        "for kind in ('end_to_end', 'layer_metrics'):",
        "    for p in (run.ROOT / kind).glob('*.py'):",
        "        run.reader(kind, p.stem)",
    ])
    assert not (_top_level_after(code) & FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    code = "\n".join(f"import {m}" for m in _modules("reference") + ["portbench.reference.dfq"])
    code += "\nfrom portbench.reference.dfq import " + ", ".join(
        p.stem for p in sorted((REPO / "portbench" / "reference" / "dfq").glob("*.py"))
        if p.stem != "__init__")
    loaded = _top_level_after(code)
    assert not (loaded & (FORBIDDEN | {"dfq_tpu_torch"}))
