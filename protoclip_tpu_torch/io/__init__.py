"""Serving IO of the port.  This slice has the canonical serving encode
(:func:`make_encode_fn`); the exported bundles come with the serving
slice."""

from protoclip_tpu_torch.io.export import make_encode_fn

__all__ = ["make_encode_fn"]
