"""Matplotlib summary-figure dumps with the reference's filenames (JAX
``runner/figures.py``: the same files, figure sizes, dpi and calls, from
the same numpy arrays, so the two packages write the same pixels).

The reference treats debug figures as its manual-inspection test surface
(SURVEY.md §4.4); we keep the same filename contract so downstream tooling
and humans find identical artifacts.  matplotlib is imported inside each writer
(Agg backend); where it is absent, a writer raises ImportError.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt
    return plt


def save_phase_and_height_panel(output_dir: str, phase_vis: np.ndarray,
                                height_vis: np.ndarray, circ_mask: np.ndarray,
                                filename: str = "07_phase_and_height_FINAL_SMOOTH_ROI.png") -> str:
    """Side-by-side phase/height panel (``shape_ftp.py:1961-1992``)."""
    plt = _plt()
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    im0 = axes[0].imshow(phase_vis, cmap="coolwarm")
    axes[0].contour(circ_mask, colors="k", linewidths=0.5)
    axes[0].set_title("Phase diff (unwrapped, OUTPUT-RELIABLE only)")
    axes[0].axis("off")
    fig.colorbar(im0, ax=axes[0], shrink=0.7)
    im1 = axes[1].imshow(height_vis, cmap="viridis")
    axes[1].contour(circ_mask, colors="k", linewidths=0.5)
    axes[1].set_title("Height map (frontier -> 0, smooth)")
    axes[1].axis("off")
    fig.colorbar(im1, ax=axes[1], shrink=0.7)
    fig.tight_layout()
    path = os.path.join(output_dir, filename)
    fig.savefig(path, dpi=300, bbox_inches="tight")
    plt.close(fig)
    return path


def save_temperature_colormap(output_dir: str, temp_map: np.ndarray, roi: np.ndarray,
                              filename: str, vmin: float, vmax: float,
                              cmap: str = "jet", title: Optional[str] = None) -> str:
    """(``temperature_sensor.py:642-657``)."""
    plt = _plt()
    m = temp_map.copy()
    m[~roi] = np.nan
    fig = plt.figure(figsize=(8, 8), dpi=200)
    ax = fig.add_subplot(111)
    im = ax.imshow(m, cmap=cmap, vmin=vmin, vmax=vmax)
    ax.set_axis_off()
    if title:
        ax.set_title(title, fontsize=20)
    cbar = fig.colorbar(im, ax=ax, fraction=0.046, pad=0.02)
    cbar.set_label("Temperature (°C)")
    fig.tight_layout(pad=0)
    path = os.path.join(output_dir, filename)
    fig.savefig(path, bbox_inches="tight", pad_inches=0)
    plt.close(fig)
    return path


def save_temperature_overlay(output_dir: str, image_bgr: np.ndarray,
                             temp_map: np.ndarray, roi: np.ndarray, filename: str,
                             vmin: float, vmax: float, cmap: str = "jet",
                             alpha: float = 0.55, title: Optional[str] = None) -> str:
    """(``temperature_sensor.py:660-679``)."""
    plt = _plt()
    rgb = image_bgr[..., ::-1].astype(np.uint8)
    m = temp_map.copy()
    m[~roi] = np.nan
    fig = plt.figure(figsize=(8, 8), dpi=200)
    ax = fig.add_subplot(111)
    ax.imshow(rgb)
    im = ax.imshow(m, cmap=cmap, vmin=vmin, vmax=vmax, alpha=float(alpha))
    ax.set_axis_off()
    if title:
        ax.set_title(title)
    cbar = fig.colorbar(im, ax=ax, fraction=0.046, pad=0.02)
    cbar.set_label("Temperature (°C)")
    fig.tight_layout(pad=0)
    path = os.path.join(output_dir, filename)
    fig.savefig(path, bbox_inches="tight", pad_inches=0)
    plt.close(fig)
    return path


def save_horizontal_legend(output_dir: str, vmin: float, vmax: float,
                           cmap: str = "jet",
                           filename: str = "temperature_legend_horizontal.png") -> str:
    """(``temperature_sensor.py:682-698``)."""
    plt = _plt()
    from matplotlib import cm, colors
    fig = plt.figure(figsize=(10, 1.2), dpi=200)
    cax = fig.add_axes([0.06, 0.55, 0.88, 0.25])
    norm = colors.Normalize(vmin=float(vmin), vmax=float(vmax))
    sm = cm.ScalarMappable(norm=norm, cmap=cmap)
    sm.set_array([])
    cbar = fig.colorbar(sm, cax=cax, orientation="horizontal")
    cbar.set_label("Temperature (°C)")
    path = os.path.join(output_dir, filename)
    fig.savefig(path, bbox_inches="tight", pad_inches=0)
    plt.close(fig)
    return path


def _heightmap_3d_figure(plt, height_map: np.ndarray,
                         circ_mask: Optional[np.ndarray], title: str):
    """Downsampled 3-D surface figure of a (masked) heightmap
    (``force_sensor.py:66-87``, ``shape_ftp.py:1330-1351``)."""
    h, w = height_map.shape
    Y, X = np.mgrid[0:h, 0:w]
    Z = height_map.astype(float).copy()
    if circ_mask is not None:
        Z[~circ_mask] = np.nan
    step = max(1, int(min(h, w) / 350))
    Zm = np.ma.masked_invalid(Z[::step, ::step])
    fig = plt.figure(figsize=(7, 5))
    ax = fig.add_subplot(111, projection="3d")
    surf = ax.plot_surface(X[::step, ::step], Y[::step, ::step], Zm,
                           cmap="viridis", linewidth=0, antialiased=True)
    ax.set_title(title)
    ax.set_xlabel("x (pixels)")
    ax.set_ylabel("y (pixels)")
    ax.set_zlabel("height (mm)")
    fig.colorbar(surf, shrink=0.6, label="mm")
    return fig


def save_heightmap_3d(output_dir: str, height_map: np.ndarray,
                      circ_mask: Optional[np.ndarray], title: str,
                      filename: str = "heightmap_3d.png") -> str:
    """Static render of the interactive 3-D surface
    (``shape_ftp.py:1330-1351``)."""
    plt = _plt()
    fig = _heightmap_3d_figure(plt, height_map, circ_mask, title)
    path = os.path.join(output_dir, filename)
    fig.savefig(path, dpi=200, bbox_inches="tight")
    plt.close(fig)
    return path


def show_heightmap_3d_interactive(height_map: np.ndarray,
                                  circ_mask: Optional[np.ndarray],
                                  title: str, block: bool = True) -> None:
    """Open the interactive 3-D heightmap window and block until the user
    closes it (``multimodal_sensor.py:670-679``, ``force_sensor.py:66-87``).

    Uses the default (GUI) matplotlib backend; on a headless/Agg session the
    window is a no-op render and the call returns immediately."""
    import matplotlib
    has_display = bool(os.environ.get("DISPLAY")
                       or os.environ.get("WAYLAND_DISPLAY"))
    if has_display and matplotlib.get_backend().lower().endswith("agg"):
        # save_* helpers force Agg; restore a GUI backend when a display exists
        for backend in ("QtAgg", "TkAgg", "GTK3Agg"):
            try:
                matplotlib.use(backend, force=True)
                break
            except Exception:
                continue
    import matplotlib.pyplot as plt
    fig = _heightmap_3d_figure(plt, height_map, circ_mask, title)
    headless = matplotlib.get_backend().lower().endswith("agg")
    if headless and block:
        print("vistaf: --show-3d requested but no GUI backend is available "
              "(headless session); skipping the interactive window",
              flush=True)
    plt.show(block=block and not headless)
    plt.close(fig)


def save_force_shape_right_panel(combined_dir: str, height_vis: np.ndarray,
                                 force_N: float) -> str:
    """Combined-output heightmap panel with force in the title
    (``multimodal_sensor.py:123-174``); rendered directly from the array
    instead of re-cropping a PNG."""
    plt = _plt()
    fig = plt.figure(figsize=(6.0, 6.0), dpi=200)
    ax = fig.add_subplot(111)
    im = ax.imshow(height_vis, cmap="viridis")
    ax.set_axis_off()
    ax.set_title(f"Deformation Heightmap (mm) - Force: {force_N:.3f} N")
    fig.colorbar(im, ax=ax, shrink=0.7)
    path = os.path.join(combined_dir, "force_shape_heightmap.png")
    fig.savefig(path, bbox_inches="tight", pad_inches=0.05)
    plt.close(fig)
    return path
