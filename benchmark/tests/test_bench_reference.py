"""The plain reference held against the port at a tiny size on the CPU
(the tests may import the port; the reference may not)."""

import numpy as np
import pytest
import torch
from PIL import Image

from benchmark import inputs, weights
from benchmark.reference import head
from benchmark.reference.clip import ImageTower
from benchmark.reference.preprocess import clip_preprocess, decode

from .conftest import TINY


def test_image_tower_matches_the_port_in_fp32(tmp_path):
    from protoclip_tpu_torch.data.transforms import normalize_batch
    from protoclip_tpu_torch.models.clip import encode_image, load_clip

    sd = weights.clip_state_dict(TINY, 3, "cpu")
    torch.save(sd, tmp_path / "clip.pt")
    cfg, params = load_clip("ViT-B/16", str(tmp_path / "clip.pt"), dtype=torch.float32,
                            device="cpu")
    images = inputs.split_images(4, 6, TINY["image_resolution"], "cpu")
    with torch.no_grad():
        port = encode_image(params, normalize_batch(torch.from_numpy(images)), cfg).numpy()
    ref = ImageTower(sd, TINY["vision_heads"], "cpu", block=4)(images).numpy()
    np.testing.assert_allclose(ref, port, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("native", ["0", "1"])
def test_preprocess_is_pixel_exact_with_the_port(monkeypatch, native):
    from protoclip_tpu_torch.data import transforms

    monkeypatch.setenv("PROTOCLIP_NATIVE", native)
    rng = np.random.default_rng(0)
    crops = inputs.crops(rng, inputs.frames(1, 2), 12, (60, 200))
    for crop in crops:
        img = Image.fromarray(crop)
        np.testing.assert_array_equal(clip_preprocess(img, 224),
                                      transforms.clip_preprocess(img, 224))
    raw = inputs.jpeg(inputs.frames(2, 1)[0], 90)
    np.testing.assert_array_equal(clip_preprocess(decode(raw), 224),
                                  transforms.clip_preprocess(decode(raw), 224))


def test_head_matches_the_port(tmp_path):
    from protoclip_tpu_torch.core.protoclip import from_arrays
    from protoclip_tpu_torch.io.checkpoint import load_checkpoint_triple
    from protoclip_tpu_torch.models import adapter_from_torch_state
    from protoclip_tpu_torch.toolkit.classifier import top_k

    triple = inputs.write_triple(np.random.default_rng(1), tmp_path, 7, 3, 32)
    p = triple["paths"]
    bank_v, bank_t, state = load_checkpoint_triple(p["bank_v"], p["bank_t"], p["adapter"])
    model = from_arrays(bank_v, bank_t, adapter_from_torch_state(state, "fc"), "fc", 3,
                        device="cpu")
    feats = torch.randn(10, 32, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        port = model.probs(feats / feats.norm(dim=-1, keepdim=True), 0.2, 12.0)
    ref = head.probabilities(feats, triple["bank_v"], triple["bank_t"], triple["adapter"],
                             0.2, 12.0, 3)
    np.testing.assert_allclose(ref.numpy(), port.double().numpy(), rtol=1e-5)
    np.testing.assert_array_equal(head.top_k(ref, 5)[1].numpy(), top_k(port, 5)[1].numpy())


def test_top_k_orders_ties_by_index():
    values, ids = head.top_k(torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3]], dtype=torch.float64), 4)
    assert ids.tolist() == [[1, 2, 4, 3]]
    assert values.tolist() == [[0.3, 0.3, 0.3, 0.2]]
