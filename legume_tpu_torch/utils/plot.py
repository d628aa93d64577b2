"""Figures of `senna plot`, `senna plot-topic`, `senna plot-strand`,
`pinto p` and `pinto interfaces` (the port's copy of the functions of
the JAX package's `utils/plot.py` that these commands use).

matplotlib's Agg/SVG/PDF backends draw the reference's artifact kinds:
embedding scatters coloured by cluster, topic, pseudotime or annotation,
admixture structure bars, Hinton diagrams and strand ideograms. matplotlib is imported
only when a figure is drawn.
"""

from __future__ import annotations

import numpy as np

# 2-6-2 qualitative palette in the spirit of plot-utils' palettes
PALETTE = [
    "#4E79A7", "#F28E2B", "#E15759", "#76B7B2", "#59A14F",
    "#EDC948", "#B07AA1", "#FF9DA7", "#9C755F", "#BAB0AC",
    "#1B9E77", "#D95F02", "#7570B3", "#E7298A", "#66A61E",
]


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def structure_bars(
    proportions: np.ndarray,  # [N, K] simplex rows
    out: str,
    *,
    order_by: np.ndarray | None = None,
    title: str = "",
):
    """Admixture-style stacked bars (plot-utils structure plots)."""
    plt = _mpl()
    p = np.asarray(proportions)
    order = (
        np.argsort(order_by)
        if order_by is not None
        else np.lexsort((p.argmax(1), -p.max(1)))[::-1]
    )
    p = p[order]
    fig, ax = plt.subplots(figsize=(8, 3), dpi=150)
    bottom = np.zeros(len(p))
    x = np.arange(len(p))
    for k in range(p.shape[1]):
        ax.bar(
            x, p[:, k], bottom=bottom, width=1.0,
            color=PALETTE[k % len(PALETTE)], linewidth=0,
        )
        bottom += p[:, k]
    ax.set_xlim(0, len(p))
    ax.set_ylim(0, 1)
    ax.set_title(title)
    ax.set_xticks([])
    fig.tight_layout()
    fig.savefig(out)
    plt.close(fig)


def strand_ideogram(
    activity: np.ndarray,  # [G] per-gene activity for one group
    chrom: np.ndarray,  # [G] chromosome index per gene
    pos: np.ndarray,  # [G] genomic position (TSS)
    strand: np.ndarray,  # [G] +1 / -1
    chrom_names: list,
    out: str,
    *,
    bins: int = 200,
    title: str = "",
):
    """Watson/Crick mirrored genomic-activity ideogram (`senna
    plot-strand`; postprocess/plot/strand/mod.rs): per chromosome,
    forward-strand gene activity binned and filled upward, reverse
    mirrored downward around a shared axis; chromosomes stacked."""
    plt = _mpl()
    n_chrom = len(chrom_names)
    fig, axes = plt.subplots(
        n_chrom, 1, figsize=(10, 1.1 * n_chrom), squeeze=False, sharex=False
    )
    for c in range(n_chrom):
        ax = axes[c, 0]
        m = chrom == c
        if m.any():
            p = pos[m].astype(float)
            a = activity[m]
            s = strand[m]
            lo, hi = p.min(), max(p.max(), p.min() + 1)
            edges = np.linspace(lo, hi, bins + 1)
            up, _ = np.histogram(p[s > 0], bins=edges, weights=a[s > 0])
            dn, _ = np.histogram(p[s < 0], bins=edges, weights=a[s < 0])
            centers = (edges[:-1] + edges[1:]) / 2
            ax.fill_between(centers, 0, up, step="mid", color=PALETTE[0], lw=0)
            ax.fill_between(centers, 0, -dn, step="mid", color=PALETTE[2], lw=0)
        ax.axhline(0, color="k", lw=0.5)
        ax.set_ylabel(chrom_names[c], rotation=0, ha="right", va="center", fontsize=7)
        ax.set_yticks([])
        for side in ("top", "right", "left"):
            ax.spines[side].set_visible(False)
    if title:
        axes[0, 0].set_title(title, fontsize=9)
    fig.tight_layout()
    fig.savefig(out, dpi=150)
    plt.close(fig)
    return out


def hinton(
    matrix: np.ndarray,
    out: str,
    *,
    row_labels=None,
    col_labels=None,
    max_weight: float | None = None,
    title: str = "",
):
    """Hinton diagram (plot-utils hinton role): square area encodes
    |value|, color encodes sign. Used by `senna plot-topic` for the
    gene x topic dictionary at <= 100 genes."""
    plt = _mpl()
    m = np.asarray(matrix, float)
    if max_weight is None:
        max_weight = 2 ** np.ceil(np.log2(np.abs(m).max() + 1e-12))
    r, c = m.shape
    fig, ax = plt.subplots(figsize=(max(c * 0.25, 2), max(r * 0.25, 2)))
    ax.set_facecolor("#f5f5f5")
    for (i, j), w in np.ndenumerate(m):
        size = min(np.sqrt(abs(w) / max_weight), 1.0)
        if size <= 0:
            continue
        color = PALETTE[0] if w > 0 else PALETTE[2]
        ax.add_patch(
            plt.Rectangle(
                [j - size / 2, i - size / 2], size, size,
                facecolor=color, edgecolor="none",
            )
        )
    ax.set_xlim(-0.5, c - 0.5)
    ax.set_ylim(r - 0.5, -0.5)
    ax.set_aspect("equal")
    if col_labels is not None:
        ax.set_xticks(range(c))
        ax.set_xticklabels(col_labels, rotation=90, fontsize=6)
    if row_labels is not None:
        ax.set_yticks(range(r))
        ax.set_yticklabels(row_labels, fontsize=6)
    if title:
        ax.set_title(title, fontsize=9)
    fig.tight_layout()
    fig.savefig(out, dpi=150)
    plt.close(fig)
    return out


def scatter_figure(
    coords: np.ndarray,  # [N, 2]
    outputs: list,  # file paths (one per requested format)
    *,
    labels: "np.ndarray | None" = None,  # discrete colors + legend
    values: "np.ndarray | None" = None,  # continuous colormap
    title: str = "",
    width: float = 6.0,
    height: float = 5.0,
    dpi: int = 150,
    point_size: float = 3.0,
    alpha: float = 1.0,
    hull: bool = False,
    hull_coverage: float = 0.9,
    hull_fill_alpha: float = 0.15,
    show_labels: bool = True,
    label_font_size: float = 8.0,
):
    """Full-surface embedding scatter (plot/scatter.rs PlotArgs role):
    discrete labels OR a continuous value channel, optional per-cluster
    convex hulls over the central coverage fraction, optional centroid
    label text, multi-format output."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(width, height), dpi=dpi)
    if values is not None:
        sc = ax.scatter(
            coords[:, 0], coords[:, 1], s=point_size, c=np.asarray(values),
            cmap="viridis", alpha=alpha, linewidths=0,
        )
        fig.colorbar(sc, ax=ax, shrink=0.8)
    else:
        lab = np.zeros(len(coords), int) if labels is None else np.asarray(labels)
        uniq = np.unique(lab)
        for i, lv in enumerate(uniq):
            m = lab == lv
            color = PALETTE[i % len(PALETTE)]
            ax.scatter(
                coords[m, 0], coords[m, 1], s=point_size, color=color,
                alpha=alpha, label=str(lv), linewidths=0,
            )
            if hull and m.sum() >= 4:
                from scipy.spatial import ConvexHull

                pts = coords[m]
                ctr = pts.mean(0)
                d = np.linalg.norm(pts - ctr, axis=1)
                keep = pts[d <= np.quantile(d, hull_coverage)]
                if len(keep) >= 3:
                    try:
                        h = ConvexHull(keep)
                        poly = keep[h.vertices]
                        ax.fill(
                            poly[:, 0], poly[:, 1], facecolor=color,
                            alpha=hull_fill_alpha, edgecolor=color, lw=1.0,
                        )
                    except Exception:
                        pass
            if show_labels and labels is not None:
                ctr = coords[m].mean(0)
                ax.text(
                    ctr[0], ctr[1], str(lv), fontsize=label_font_size,
                    ha="center", va="center", weight="bold",
                )
        if labels is not None and len(uniq) <= 15 and not show_labels:
            ax.legend(markerscale=4, fontsize=7, frameon=False)
    ax.set_title(title)
    ax.set_xticks([])
    ax.set_yticks([])
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    fig.tight_layout()
    for out in outputs:
        fig.savefig(out, dpi=dpi)
    plt.close(fig)
    return outputs


# ---- pinto's figures (`pinto p`, `pinto interfaces`) ----------------------


def scatter_by_label(
    coords: np.ndarray,  # [N, 2]
    labels: np.ndarray,
    out: str,
    *,
    title: str = "",
    point_size: float = 3.0,
):
    """Embedding scatter colored by discrete labels (senna plot)."""
    plt = _mpl()
    labels = np.asarray(labels)
    uniq = np.unique(labels)
    fig, ax = plt.subplots(figsize=(6, 5), dpi=150)
    for i, lab in enumerate(uniq):
        m = labels == lab
        ax.scatter(
            coords[m, 0], coords[m, 1], s=point_size,
            color=PALETTE[i % len(PALETTE)], label=str(lab), linewidths=0,
        )
    ax.set_title(title)
    ax.set_xticks([])
    ax.set_yticks([])
    if len(uniq) <= 15:
        ax.legend(markerscale=4, fontsize=7, frameon=False)
    fig.tight_layout()
    fig.savefig(out)
    plt.close(fig)


def spatial_hex(
    coords: np.ndarray,  # [N, 2] spatial coordinates
    values: np.ndarray,
    out: str,
    *,
    title: str = "",
    gridsize: int = 60,
):
    """Hex-binned spatial map (pinto plot hex scatter)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(6, 5), dpi=150)
    hb = ax.hexbin(
        coords[:, 0], coords[:, 1], C=np.asarray(values),
        gridsize=gridsize, cmap="viridis", linewidths=0,
    )
    fig.colorbar(hb, ax=ax, shrink=0.8)
    ax.set_title(title)
    ax.set_aspect("equal")
    fig.tight_layout()
    fig.savefig(out)
    plt.close(fig)


def interface_map(
    coords: np.ndarray,  # [N, 2]
    entropy: np.ndarray,  # [N]
    focal: np.ndarray,  # focal cell indices
    out: str,
    *,
    title: str = "interfaces",
):
    """Entropy-as-grayscale+size overview with focal cells highlighted
    (pinto/src/plot/interfaces.rs figure: radius scales with the
    entropy quantile; darkest/largest = strongest interface)."""
    plt = _mpl()
    ent = np.asarray(entropy, np.float64)
    lo, hi = float(ent.min()), float(ent.max())
    q = (ent - lo) / max(hi - lo, 1e-12)
    fig, ax = plt.subplots(figsize=(6, 5), dpi=150)
    ax.scatter(
        coords[:, 0], coords[:, 1], s=2 + 28 * q, c=0.85 - 0.7 * q,
        cmap="gray", vmin=0, vmax=1, linewidths=0,
    )
    if len(focal):
        ax.scatter(
            coords[focal, 0], coords[focal, 1], s=46,
            facecolors="none", edgecolors="crimson", linewidths=0.8,
        )
    ax.set_title(title)
    ax.set_aspect("equal")
    fig.tight_layout()
    fig.savefig(out)
    plt.close(fig)


def mesh_figure(
    coords: np.ndarray,      # [N, 2]
    edges: np.ndarray,       # [E, 2] cell index pairs
    out: str,
    *,
    cell_labels: np.ndarray | None = None,  # discrete per-cell (argmax community)
    edge_labels: np.ndarray | None = None,  # discrete per-edge community
    title: str = "",
):
    """Spatial graph mesh (pinto plot `mesh` kind): the lc edge graph
    drawn over cell coordinates at low opacity so dense kNN graphs do
    not drown the community colours (`pinto/src/plot/mod.rs` MESH_ALPHA
    rationale), cells colored by their argmax community on top."""
    plt = _mpl()
    from matplotlib.collections import LineCollection

    fig, ax = plt.subplots(figsize=(6.5, 5.5), dpi=150)
    segs = np.stack([coords[edges[:, 0]], coords[edges[:, 1]]], axis=1)
    if edge_labels is not None:
        cols = [PALETTE[int(l) % len(PALETTE)] for l in edge_labels]
    else:
        cols = "#888888"
    ax.add_collection(LineCollection(segs, colors=cols, linewidths=0.4, alpha=0.3))
    if cell_labels is not None:
        labs = np.asarray(cell_labels)
        for i, lab in enumerate(np.unique(labs)):
            m = labs == lab
            ax.scatter(coords[m, 0], coords[m, 1], s=4,
                       color=PALETTE[i % len(PALETTE)], label=str(lab),
                       linewidths=0)
        if np.unique(labs).size <= 15:
            ax.legend(markerscale=3, fontsize=7, frameon=False,
                      loc="center left", bbox_to_anchor=(1.0, 0.5))
    else:
        ax.scatter(coords[:, 0], coords[:, 1], s=3, color="#444444",
                   linewidths=0)
    ax.set_title(title)
    ax.set_xticks([])
    ax.set_yticks([])
    ax.autoscale()
    fig.tight_layout()
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)


def lr_overlay(
    coords: np.ndarray,        # [N, 2]
    ligand_expr: np.ndarray,   # [N]
    receptor_expr: np.ndarray, # [N]
    out: str,
    *,
    title: str = "",
):
    """Ligand-receptor activity overlay (pinto plot `lr` kind,
    `lr_overlay.rs` role): faint gray scatter of all cells with
    ligand-expressing cells in one colour, receptor-expressing in
    another, co-expressing in a third — the spatial footprint of the
    pair the activity statistic scored."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(6.5, 5.5), dpi=150)
    ax.scatter(coords[:, 0], coords[:, 1], s=3, color="#CCCCCC", linewidths=0)
    lig = np.asarray(ligand_expr) > 0
    rec = np.asarray(receptor_expr) > 0
    both = lig & rec
    ax.scatter(coords[lig & ~both, 0], coords[lig & ~both, 1], s=6,
               color="#4E79A7", linewidths=0, label="ligand")
    ax.scatter(coords[rec & ~both, 0], coords[rec & ~both, 1], s=6,
               color="#E15759", linewidths=0, label="receptor")
    ax.scatter(coords[both, 0], coords[both, 1], s=8,
               color="#59A14F", linewidths=0, label="both")
    ax.legend(markerscale=3, fontsize=7, frameon=False)
    ax.set_title(title, fontsize=9)
    ax.set_xticks([])
    ax.set_yticks([])
    fig.tight_layout()
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
