from dfq_tpu_torch.graph.ir import (  # noqa: F401
    Graph,
    GraphBuilder,
    Node,
    node_sites,
    quant_sites,
)
from dfq_tpu_torch.graph.executor import execute  # noqa: F401
