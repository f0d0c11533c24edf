"""Visualization utilities (matplotlib, Agg backend).

Counterpart of icsg3d_tpu/viz.py: voxel-grid renderings,
real-vs-reconstruction panels, slice plots, interpolation strips, 3D species
scatters, latent KDE / t-SNE plots, and loss curves.  Everything from
``plot_slices`` down is the JAX module's code (tests/test_torch_guards.py
holds it equal); only the import block differs: matplotlib is imported on
the first plot call, so this module imports where matplotlib is missing
(the card's machine has none) and that first call raises an ImportError
naming it.  ``available()`` says beforehand whether plots can be drawn.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

PLOTS_SKIPPED = "plots skipped: matplotlib is not installed"


def available() -> bool:
    """Whether matplotlib imports here."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


class _Pyplot:
    """``matplotlib.pyplot`` with the Agg backend, imported on first use."""

    def __init__(self):
        self._module = None

    def __getattr__(self, name):
        if self._module is None:
            try:
                import matplotlib
            except ImportError as e:
                raise ImportError(
                    "plotting needs matplotlib, which is not installed"
                ) from e
            matplotlib.use("Agg")
            import matplotlib.pyplot as pyplot

            self._module = pyplot
        return getattr(self._module, name)


plt = _Pyplot()


def plot_slices(
    grid: np.ndarray, path: str, axis: int = 2, n_slices: int = 8, channel: int = 0
):
    """Evenly-spaced 2D slices through a (d,d,d) or (d,d,d,C) grid
    (reference viz.py:107-156 animation, as a static strip)."""
    g = np.asarray(grid)
    if g.ndim == 4:
        g = g[..., channel]
    d = g.shape[axis]
    idxs = np.linspace(0, d - 1, n_slices).astype(int)
    fig, axes = plt.subplots(1, n_slices, figsize=(2 * n_slices, 2))
    for ax, i in zip(np.atleast_1d(axes), idxs):
        sl = np.take(g, i, axis=axis)
        ax.imshow(sl)
        ax.set_xticks([]); ax.set_yticks([])
        ax.set_title(f"{'xyz'[axis]}={i}", fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_real_vs_pred(
    real: np.ndarray, pred: np.ndarray, path: str, slice_idx: Optional[int] = None
):
    """Side-by-side center slices, one row per sample (viz.py:69-105)."""
    real, pred = np.asarray(real), np.asarray(pred)
    if real.ndim != pred.ndim:
        raise ValueError(
            f"real/pred rank mismatch: {real.shape} vs {pred.shape}"
        )
    if real.ndim == 4:
        real, pred = real[None], pred[None]
    n = len(real)
    k = slice_idx if slice_idx is not None else real.shape[3] // 2
    fig, axes = plt.subplots(n, 2, figsize=(5, 2.2 * n), squeeze=False)
    for i in range(n):
        axes[i][0].imshow(real[i, :, :, k, 0])
        axes[i][1].imshow(pred[i, :, :, k, 0])
        for a in axes[i]:
            a.set_xticks([]); a.set_yticks([])
    axes[0][0].set_title("real"); axes[0][1].set_title("reconstruction")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_interpolation(grids: np.ndarray, path: str, channel: int = 0):
    """One row of center slices across interpolation steps
    (interpolate.py:174-202)."""
    grids = np.asarray(grids)
    if grids.ndim == 4:  # channel-less stack, like plot_slices accepts
        grids = grids[..., None]
        channel = 0
    n = len(grids)
    k = grids.shape[3] // 2
    fig, axes = plt.subplots(1, n, figsize=(2 * n, 2))
    for ax, g in zip(np.atleast_1d(axes), grids):
        ax.imshow(g[:, :, k, channel])
        ax.set_xticks([]); ax.set_yticks([])
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def _explode(data: np.ndarray) -> np.ndarray:
    """Insert empty voxels between filled ones so faces don't merge
    (reference viz.py:28-34)."""
    size = np.array(data.shape[:3]) * 2 - 1
    out = np.zeros(tuple(size) + data.shape[3:], dtype=data.dtype)
    out[::2, ::2, ::2] = data
    return out


def _expand_coordinates(indices):
    """Stretch voxel corner coordinates for the exploded grid
    (reference viz.py:36-41)."""
    x, y, z = indices
    x[1::2, :, :] += 1
    y[:, 1::2, :] += 1
    z[:, :, 1::2] += 1
    return x, y, z


def _resample(grid: np.ndarray, d: int) -> np.ndarray:
    from scipy.ndimage import zoom

    factors = [d / s for s in grid.shape]
    return zoom(grid, factors, order=1)


def plot_voxels_3d(
    grid: np.ndarray,
    path: Optional[str] = None,
    alpha: float = 0.2,
    resample_d: int = 20,
    ax=None,
    cmap: str = "viridis",
):
    """Exploded translucent 3D voxel render of a (d,d,d) density grid
    (reference viz.py:45-66).  Downsamples to ``resample_d`` first —
    ax.voxels is quadratic-slow in voxel count."""
    g = np.asarray(grid, dtype=np.float64)
    if g.ndim == 4:
        g = g[..., 0]
    if resample_d and g.shape[0] != resample_d:
        g = _resample(g, resample_d)
    lo, hi = g.min(), g.max()
    g = (g - lo) / (hi - lo) if hi > lo else np.zeros_like(g)

    colors = plt.get_cmap(cmap)(g)
    colors = _explode(colors)
    filled = colors[..., -1] != 0
    x, y, z = _expand_coordinates(np.indices(np.array(filled.shape) + 1))

    own_fig = ax is None
    if own_fig:
        fig = plt.figure(figsize=(5, 5))
        ax = fig.add_subplot(projection="3d")
    ax.voxels(x, y, z, filled, facecolors=colors, alpha=alpha)
    ax.set_xticks([]); ax.set_yticks([]); ax.set_zticks([])
    if path is not None:
        # honor path regardless of who owns the figure (a caller-supplied
        # ax with a path used to silently write nothing)
        ax.figure.savefig(path, dpi=120)
    if own_fig:
        # close even without a path: an unsaved own figure stayed
        # registered in pyplot forever (leaks across sample loops)
        plt.close(ax.figure)
    return ax


def plot_voxels_duo(
    real: np.ndarray,
    pred: np.ndarray,
    path: str,
    alpha: float = 0.2,
    resample_d: int = 12,
):
    """Side-by-side exploded voxel renders of two grids
    (reference viz.py:69-105 viz_duo)."""
    fig = plt.figure(figsize=(9, 5))
    for i, (g, title) in enumerate(((real, "real"), (pred, "generated"))):
        ax = fig.add_subplot(1, 2, i + 1, projection="3d")
        plot_voxels_3d(g, alpha=alpha, resample_d=resample_d, ax=ax)
        ax.set_title(title)
    fig.savefig(path, dpi=120)
    plt.close(fig)


def save_slice_animation(
    m: np.ndarray,
    s: Optional[np.ndarray],
    path: str,
    axis: int = 2,
    fps: int = 5,
):
    """Animated sweep through grid slices, saved as a GIF (reference
    viz.py:107-119 animate — interactive plt.pause loop there; here a
    file so it works headless).  ``s`` optionally adds a second panel."""
    from matplotlib import animation

    grids = [np.asarray(g) for g in ((m,) if s is None else (m, s))]
    grids = [g[..., 0] if g.ndim == 4 else g for g in grids]
    # min across panels: a shorter second grid used to IndexError
    # mid-save once the writer passed its extent
    d = min(g.shape[axis] for g in grids)
    fig, axes = plt.subplots(1, len(grids), figsize=(4 * len(grids), 4))
    axes = np.atleast_1d(axes)
    ims = []
    for ax, g in zip(axes, grids):
        im = ax.imshow(np.take(g, 0, axis=axis), vmin=g.min(), vmax=g.max())
        ax.set_xticks([]); ax.set_yticks([])
        ims.append((im, g))

    def update(i):
        for im, g in ims:
            im.set_data(np.take(g, i, axis=axis))
        return [im for im, _ in ims]

    anim = animation.FuncAnimation(fig, update, frames=d, blit=True)
    anim.save(path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)


def _tsne_embed(z: np.ndarray, seed: int) -> np.ndarray:
    """2D t-SNE with a perplexity valid for ANY sample count (sklearn
    requires perplexity < n_samples; tiny demo sets crashed)."""
    from sklearn.manifold import TSNE

    n = len(z)
    if n < 3:
        # too few points for t-SNE; a trivial spread keeps callers working
        return np.column_stack([np.arange(n, dtype=float), np.zeros(n)])
    perplexity = min(30.0, max(2.0, n / 4), (n - 1) / 1.001)
    return TSNE(
        n_components=2, random_state=seed, perplexity=perplexity
    ).fit_transform(z)


def plot_tsne_thumbnails(
    z: np.ndarray,
    images: np.ndarray,
    path: str,
    zoom: float = 1.0,
    seed: int = 0,
):
    """t-SNE of latents with grid-slice thumbnails at each point
    (reference viz.py:158-181 imscatter/tsne_latent)."""
    from matplotlib.offsetbox import AnnotationBbox, OffsetImage

    z = np.asarray(z)
    emb = _tsne_embed(z, seed)
    fig, ax = plt.subplots(figsize=(8, 8))
    for (x0, y0), img in zip(emb, images):
        img = np.asarray(img)
        if img.ndim == 4:  # (d,d,d,C) grid -> center slice of channel 0
            img = img[:, :, img.shape[2] // 2, 0]
        elif img.ndim == 3 and not (
            img.shape[-1] in (3, 4) and img.shape[-1] != img.shape[0]
        ):
            # a volume, not an RGB(A) image: a (d,d,3)-deep slice stack
            # used to render as garbage RGB
            img = img[:, :, img.shape[2] // 2]
        ab = AnnotationBbox(
            OffsetImage(img, zoom=zoom), (x0, y0), xycoords="data", frameon=True
        )
        ax.add_artist(ab)
    ax.update_datalim(np.column_stack([emb[:, 0], emb[:, 1]]))
    ax.autoscale()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_points_3d(labels: np.ndarray, path: str):
    """3D scatter of nonzero voxels, one legend entry per species
    (viz.py:207-233 scatters per unique label with a legend)."""
    from icsg3d_torch.crystal import elements

    labels = np.asarray(labels)
    fig = plt.figure(figsize=(5, 5))
    ax = fig.add_subplot(projection="3d")
    uniques = np.unique(labels[labels != 0])
    cmap = plt.get_cmap("tab20")
    for j, u in enumerate(uniques):
        idx = np.argwhere(labels == u)
        try:
            name = elements.z_to_symbol(int(u))
        except Exception:
            name = str(int(u))
        ax.scatter(
            idx[:, 0], idx[:, 1], idx[:, 2],
            color=cmap(j % 20), s=6, label=name,
        )
    if len(uniques):
        ax.legend(loc="upper right", fontsize=7)
    # per-axis limits: one shared shape[0] drew non-cubic grids wrong
    ax.set_xlim(0, labels.shape[0])
    ax.set_ylim(0, labels.shape[1])
    ax.set_zlim(0, labels.shape[2])
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_losses(
    train_losses: Sequence[float], val_losses: Sequence[float], path: str
):
    """Loss curves (vae/lattice_vae.py:427-436, unet/unet.py:71-91)."""
    fig, ax = plt.subplots()
    ax.plot(train_losses, label="train loss")
    ax.plot(val_losses, label="val loss")
    ax.set_xlabel("epoch"); ax.set_ylabel("loss")
    ax.legend(loc="best")
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_latent_kde(z: np.ndarray, path: str, max_dims: int = 64):
    """Per-dimension Gaussian KDEs of encoded latents
    (vae/lattice_vae.py:402-425)."""
    from scipy import stats

    z = np.asarray(z)
    x = np.linspace(-3, 3, 50)
    fig, ax = plt.subplots()
    for i in range(min(z.shape[1], max_dims)):
        col = z[:, i]
        if np.std(col) < 1e-8:
            continue
        ax.plot(x, stats.gaussian_kde(col)(x), lw=0.5)
    ax.set_xlabel("$x$"); ax.set_ylabel("density")
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_latent_tsne(z: np.ndarray, path: str, colors=None, seed: int = 0):
    """2D t-SNE of latent vectors (viz.py:158-181)."""
    z = np.asarray(z)
    emb = _tsne_embed(z, seed)
    fig, ax = plt.subplots()
    ax.scatter(emb[:, 0], emb[:, 1], c=colors, cmap="viridis", s=8)
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_parity(
    true_vals: np.ndarray, pred_vals: np.ndarray, path: str, label: str = ""
):
    """Parity scatter with y=x line (eval.py:243-322)."""
    t, p = np.asarray(true_vals), np.asarray(pred_vals)
    fig, ax = plt.subplots()
    ax.scatter(t, p, s=10, alpha=0.6)
    lo, hi = min(t.min(), p.min()), max(t.max(), p.max())
    ax.plot([lo, hi], [lo, hi], "k--", lw=1)
    ax.set_xlabel(f"true {label}"); ax.set_ylabel(f"pred {label}")
    fig.savefig(path, dpi=120)
    plt.close(fig)
