"""Dataset split constants (counterpart of ``protoclip_tpu/data/splits.py``).
The split readers come with the host data-path slice."""

_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".gif", ".tif", ".tiff", ".webp")
