"""The port's download helpers (``io/download.py``) and ``load_clip``'s
opt-in ``$PROTOCLIP_AUTO_DOWNLOAD``, against the JAX package's, with
``file://`` URLs and local archives only: nothing is fetched."""

import hashlib
import io
import os
import tarfile
import zipfile

import numpy as np
import pytest
import torch

from protoclip_tpu.io import download as jdl

from protoclip_tpu_torch import io as port_io
from protoclip_tpu_torch.io import download as dl
from protoclip_tpu_torch.models import clip
from protoclip_tpu_torch.parallel.dryrun import tiny_state_dict


def _served(tmp_path, payload: bytes, name="blob.bin", with_sha_segment=True):
    """``payload`` under a ``.../<sha256>/<name>`` path (the release URLs'
    layout) and its ``file://`` URL."""
    sha = hashlib.sha256(payload).hexdigest()
    folder = tmp_path / "mirror" / (sha if with_sha_segment else "plain")
    folder.mkdir(parents=True, exist_ok=True)
    (folder / name).write_bytes(payload)
    return f"file://{folder / name}", sha


def test_exports_and_constants_match_jax():
    assert dl.MODEL_URLS == jdl.MODEL_URLS
    for name in ("download_and_extract", "download_weights", "extract_archive"):
        assert getattr(port_io, name) is getattr(dl, name)
    assert not issubclass(dl.ChecksumError, OSError)


@pytest.mark.parametrize("module", [dl, jdl], ids=["port", "jax"])
def test_download_url_verifies_reuses_and_leaves_no_tmp(tmp_path, module):
    payload = os.urandom(3 << 20)
    url, sha = _served(tmp_path, payload)
    root = tmp_path / f"cache_{module.__name__.split('.')[0]}"
    path = module.download_url(url, str(root), progress=False)  # sha from the URL
    assert open(path, "rb").read() == payload and os.path.basename(path) == "blob.bin"
    os.utime(path, (1, 1))
    assert module.download_url(url, str(root), progress=False) == path
    assert os.stat(path).st_mtime == 1  # a verified file is reused, not fetched

    open(path, "wb").write(b"corrupt")  # a mismatching file is fetched again
    assert open(module.download_url(url, str(root), progress=False), "rb").read() == payload

    with pytest.raises(module.ChecksumError, match="SHA-256"):
        module.download_url(url, str(tmp_path / "bad"), expected_sha256="0" * 64,
                            progress=False)
    assert os.listdir(tmp_path / "bad") == []  # the failed download's tmp file is swept
    assert sorted(os.listdir(root)) == ["blob.bin"]


def test_port_and_jax_download_the_same_bytes(tmp_path):
    url, sha = _served(tmp_path, os.urandom(1 << 16), with_sha_segment=False)
    a = dl.download_url(url, str(tmp_path / "a"), expected_sha256=sha, progress=True)
    b = jdl.download_url(url, str(tmp_path / "b"), expected_sha256=sha, progress=False)
    assert open(a, "rb").read() == open(b, "rb").read()


def _archives(tmp_path):
    files = {"data/a.txt": b"alpha", "data/sub/b.bin": bytes(range(256))}
    tar_path, zip_path = tmp_path / "src.tar.gz", tmp_path / "src.zip"
    with tarfile.open(tar_path, "w:gz") as tar:
        for name, data in files.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    with zipfile.ZipFile(zip_path, "w") as zf:
        for name, data in files.items():
            zf.writestr(name, data)
    return files, {"tar": tar_path, "zip": zip_path}


@pytest.mark.parametrize("kind", ["tar", "zip"])
def test_extract_archive_and_download_and_extract_as_jax(tmp_path, kind):
    files, archives = _archives(tmp_path)
    for module, dest in ((dl, tmp_path / "port"), (jdl, tmp_path / "jax")):
        module.extract_archive(str(archives[kind]), str(dest))
        for name, data in files.items():
            assert (dest / name).read_bytes() == data
    payload = archives[kind].read_bytes()
    url, _ = _served(tmp_path, payload, name=archives[kind].name)
    root = tmp_path / "dl"
    assert dl.download_and_extract(url, str(root), progress=False, keep_archive=False) == str(root)
    assert (root / "data" / "a.txt").read_bytes() == b"alpha"
    assert not (root / archives[kind].name).exists()
    (tmp_path / "plain.txt").write_text("not an archive")
    with pytest.raises(ValueError, match="neither a tar archive nor a zip file"):
        dl.extract_archive(str(tmp_path / "plain.txt"), str(tmp_path / "x"))


def test_extract_archive_refuses_a_member_that_escapes(tmp_path):
    tar_path = tmp_path / "evil.tar"
    with tarfile.open(tar_path, "w") as tar:
        info = tarfile.TarInfo("../escaped.txt")
        info.size = 3
        tar.addfile(info, io.BytesIO(b"bad"))
    with pytest.raises(tarfile.TarError):
        dl.extract_archive(str(tar_path), str(tmp_path / "dest"))
    assert not (tmp_path / "escaped.txt").exists()


def test_download_weights_pinned_url(tmp_path, monkeypatch):
    buf = io.BytesIO()
    torch.save(tiny_state_dict(np.random.default_rng(0)), buf)
    url, _ = _served(tmp_path, buf.getvalue(), name="ViT-B-16.pt")
    monkeypatch.setitem(dl.MODEL_URLS, "ViT-B/16", url)
    path = dl.download_weights("ViT-B/16", root=str(tmp_path / "weights"))
    assert path == str(tmp_path / "weights" / "ViT-B-16.pt")
    with pytest.raises(KeyError, match="no release URL"):
        dl.download_weights("ViT-H/99")


def test_load_clip_auto_download(tmp_path, monkeypatch):
    """Opt-in only; a downloaded file is loaded; a ``ChecksumError`` is
    never swallowed; any other failure falls through to the strict refusal
    (or random init), after the explicit path and the lookup."""
    monkeypatch.setenv("PROTOCLIP_WEIGHTS_DIR", str(tmp_path / "empty"))
    monkeypatch.setattr(clip, "_WEIGHT_DIRS", ())
    weights = tmp_path / "tiny.pt"
    torch.save(tiny_state_dict(np.random.default_rng(0)), weights)
    calls = []

    def fake_download(backbone, root=None):
        calls.append(backbone)
        return str(weights)

    monkeypatch.setattr(dl, "download_weights", fake_download)
    monkeypatch.setenv("PROTOCLIP_STRICT_WEIGHTS", "1")
    monkeypatch.delenv("PROTOCLIP_AUTO_DOWNLOAD", raising=False)
    with pytest.raises(FileNotFoundError, match="STRICT_WEIGHTS"):
        clip.load_clip("ViT-B/16", device="cpu")
    assert calls == []  # not opted in: nothing is fetched

    monkeypatch.setenv("PROTOCLIP_AUTO_DOWNLOAD", "1")
    cfg, params = clip.load_clip("ViT-B/16", dtype=torch.float32, device="cpu")
    assert calls == ["ViT-B/16"] and cfg.embed_dim == 32  # the downloaded (tiny) file
    # a weights file's transposed products arrive C-contiguous, as the
    # card's kernels take them
    assert all(t.is_contiguous() for t in _tensors(params))
    clip.load_clip("ViT-B/16", weights_path=str(weights), device="cpu")
    assert calls == ["ViT-B/16"]  # an explicit path is never replaced by a download

    def tampered(backbone, root=None):
        raise dl.ChecksumError("downloaded but SHA-256 differs")

    monkeypatch.setattr(dl, "download_weights", tampered)
    monkeypatch.delenv("PROTOCLIP_STRICT_WEIGHTS")
    with pytest.raises(dl.ChecksumError):
        clip.load_clip("ViT-B/16", device="cpu")

    def offline(backbone, root=None):
        raise OSError("no route to host")

    monkeypatch.setattr(dl, "download_weights", offline)
    monkeypatch.setenv("PROTOCLIP_STRICT_WEIGHTS", "1")
    with pytest.raises(FileNotFoundError, match="STRICT_WEIGHTS"):
        clip.load_clip("ViT-B/16", device="cpu")


def _tensors(tree):
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _tensors(value)
    elif isinstance(tree, list):
        for value in tree:
            yield from _tensors(value)
    else:
        yield tree
