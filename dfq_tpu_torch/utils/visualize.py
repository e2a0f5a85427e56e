"""Per-channel weight-range diagnostics (port of ``dfq_tpu/utils/visualize.py``):
the DFQ paper's per-output-channel weight boxplots, used before and after
equalization to show the ranges balanced. ``matplotlib`` is imported when
the function is called, so importing this module needs none."""

from __future__ import annotations

from typing import Optional

import numpy as np


def visualize_per_layer(weight, title: str = "", save_path: Optional[str] = None,
                        max_channels: int = 128):
    """Boxplot of per-output-channel weight distributions (numpy or a
    tensor). Returns the matplotlib figure (saved to ``save_path`` if
    given); raises ``ImportError`` where matplotlib is not installed."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    w = weight.detach().cpu().numpy() if hasattr(weight, "detach") else np.asarray(weight)
    flat = w.reshape(w.shape[0], -1)
    n = min(flat.shape[0], max_channels)
    fig, ax = plt.subplots(figsize=(max(8, n // 8), 4))
    ax.boxplot([flat[i] for i in range(n)], showfliers=False)
    ax.set_xlabel("output channel")
    ax.set_ylabel("weight value")
    ax.set_title(title)
    if save_path:
        fig.savefig(save_path, dpi=100, bbox_inches="tight")
        plt.close(fig)
    return fig
