"""Visualization exports: labelled point clouds and label legends.

A copy of ``openscene_tpu/utils/viz.py`` (it replaces the reference's
open3d/matplotlib path, util/util.py:157-259, with the package's own PLY
writer).  The legend's ``.txt`` sidecar is always written; the ``.jpg``
only where matplotlib imports.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..labels import convert_labels_with_palette
from .ply import write_ply_points


def export_pointcloud(path: str, points: np.ndarray,
                      colors: Optional[np.ndarray] = None) -> None:
    write_ply_points(path, np.asarray(points, dtype=np.float32), colors)


def export_labeled_cloud(path: str, points: np.ndarray, label_ids: np.ndarray,
                         palette: np.ndarray) -> None:
    colors = convert_labels_with_palette(np.asarray(label_ids), palette)
    write_ply_points(path, np.asarray(points, dtype=np.float32), colors)


def visualize_labels(u_index: Sequence[int], labels: Sequence[str],
                     palette: np.ndarray, out_name: str, ncol: int = 5):
    """Legend for the label ids present (reference util/util.py:187-203);
    writes a .txt sidecar always, a .jpg when matplotlib is available."""
    with open(out_name + ".txt", "w") as f:
        for idx in u_index:
            r, g, b = palette[idx * 3:idx * 3 + 3]
            f.write(f"{idx}\t{labels[idx]}\trgb({int(r)},{int(g)},{int(b)})\n")
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.patches as mpatches
        import matplotlib.pyplot as plt
        patches = []
        for idx in u_index:
            color = [palette[idx * 3 + c] / 255.0 for c in range(3)]
            patches.append(mpatches.Patch(color=color, label=labels[idx]))
        plt.figure()
        plt.axis("off")
        plt.legend(frameon=False, handles=patches, loc="lower left",
                   ncol=ncol, prop={"size": 5}, handlelength=0.7)
        plt.savefig(out_name, bbox_inches="tight", dpi=300)
        plt.close()
    except Exception:
        pass
