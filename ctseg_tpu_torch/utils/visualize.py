"""Visualization helpers, capability parity with capstone/utils/visualize.py
(a copy of ctseg_tpu/utils/visualize.py: the port never imports the JAX
package; tests/test_torch_data_prep.py pins the code of the two copies
equal, docstrings aside).

Array-producing functions are matplotlib-free (testable headless); plotting
wrappers import matplotlib lazily and are optional, like the reference's
notebook-oriented helpers (plot_slide/plot_windowed/plot_region_distribution,
visualize.py:9-114).
"""

from typing import Dict, Optional, Tuple

import numpy as np

from ctseg_tpu_torch.constants import STRUCTURES, WINDOWING_CONFIG

# Distinct RGB colors for the 9 structures + background transparent.
STRUCTURE_COLORS = np.array(
    [
        [0.00, 0.00, 0.00],  # background (unused)
        [0.89, 0.10, 0.11],  # BrainStem
        [0.22, 0.49, 0.72],  # Chiasm
        [0.30, 0.69, 0.29],  # Mandible
        [0.60, 0.31, 0.64],  # OpticNerve_L
        [1.00, 0.50, 0.00],  # OpticNerve_R
        [1.00, 1.00, 0.20],  # Parotid_L
        [0.65, 0.34, 0.16],  # Parotid_R
        [0.97, 0.51, 0.75],  # Submandibular_L
        [0.60, 0.60, 0.60],  # Submandibular_R
    ]
)

RADIOPAEDIA_WINDOWS: Dict[str, Tuple[int, int]] = {
    **WINDOWING_CONFIG,
    "lungs": (1500, -600),
    "mediastinum": (350, 50),
}


def window_image(image: np.ndarray, width: int, level: int) -> np.ndarray:
    """Clip + rescale a HU image to [0, 1] for display."""
    lo, hi = level - width // 2, level + width // 2
    out = np.clip(image.astype(np.float64), lo, hi)
    return (out - lo) / max(hi - lo, 1e-8)


def overlay_labels(
    image01: np.ndarray, labels: np.ndarray, alpha: float = 0.45
) -> np.ndarray:
    """Blend a [0,1] grayscale image with colored structure masks -> RGB."""
    rgb = np.repeat(image01[..., None], 3, axis=-1)
    for c in range(1, 10):
        mask = labels == c
        if mask.any():
            rgb[mask] = (1 - alpha) * rgb[mask] + alpha * STRUCTURE_COLORS[c]
    return np.clip(rgb, 0, 1)


def prediction_panel(
    image: np.ndarray,
    pred_labels: np.ndarray,
    target_labels: Optional[np.ndarray] = None,
    window: str = "soft_tissue",
) -> np.ndarray:
    """Side-by-side (H, W*k, 3) panel: windowed image | prediction [| GT]."""
    base = window_image(image, *WINDOWING_CONFIG[window])
    panels = [np.repeat(base[..., None], 3, -1), overlay_labels(base, pred_labels)]
    if target_labels is not None:
        panels.append(overlay_labels(base, target_labels))
    return np.concatenate(panels, axis=1)


def windowed_gallery(image: np.ndarray) -> Dict[str, np.ndarray]:
    """The radiopaedia window presets applied to one slice
    (reference plot_windowed, visualize.py:82-114)."""
    return {
        name: window_image(image, w, l)
        for name, (w, l) in RADIOPAEDIA_WINDOWS.items()
    }


def structure_hu_values(
    image: np.ndarray, labels: np.ndarray
) -> Dict[str, np.ndarray]:
    """Per-structure HU distributions (reference plot_region_distribution)."""
    return {
        s: image[labels == (i + 1)].ravel() for i, s in enumerate(STRUCTURES)
    }


# ------------------------------------------------------- matplotlib wrappers
def plot_slide(image, labels=None, window="soft_tissue", ax=None):
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
    base = window_image(image, *WINDOWING_CONFIG[window])
    ax.imshow(
        overlay_labels(base, labels) if labels is not None else base,
        cmap=None if labels is not None else "gray",
    )
    ax.axis("off")
    return ax


def plot_windowed(image):
    import matplotlib.pyplot as plt

    gallery = windowed_gallery(image)
    fig, axes = plt.subplots(1, len(gallery), figsize=(4 * len(gallery), 4))
    for ax, (name, img) in zip(axes, gallery.items()):
        ax.imshow(img, cmap="gray")
        ax.set_title(name)
        ax.axis("off")
    return fig


def notebook_interact(patient):
    """ipywidgets slice browser over a Patient (reference visualize.py:41-55).

    Optional: requires ipywidgets + matplotlib (notebook environments only).
    """
    import ipywidgets as widgets
    from ctseg_tpu_torch.constants import STRUCTURES

    def show(index, structures):
        import numpy as np

        image = patient.image.as_numpy()[0, index]
        labels = np.zeros_like(image, dtype=np.uint8)
        for s in structures:
            vol = patient.structures[s]
            if vol is not None:
                mask = vol.as_numpy()[0, index] > 0
                labels[mask] = STRUCTURES.index(s) + 1
        plot_slide(image, labels if structures else None)

    widgets.interact(
        show,
        index=widgets.IntSlider(min=0, max=patient.num_slides - 1),
        structures=widgets.SelectMultiple(options=STRUCTURES, value=()),
    )


def plot_region_distribution(image, labels):
    import matplotlib.pyplot as plt

    values = structure_hu_values(image, labels)
    fig, ax = plt.subplots(figsize=(10, 5))
    present = {k: v for k, v in values.items() if v.size}
    ax.boxplot(present.values(), tick_labels=present.keys())
    ax.set_ylabel("HU")
    plt.xticks(rotation=45)
    return fig
