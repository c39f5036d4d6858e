"""Checksum-verified weight downloader (ref ``clip/clip.py:30-70``;
counterpart of ``protoclip_tpu/io/download.py``).

The OpenAI CLIP release URLs embed the artifact's SHA-256 as a path
segment; the downloader streams to a temp file while hashing incrementally
(the reference re-reads the whole file to hash it), verifies, then renames
atomically so interrupted downloads never leave a corrupt cache entry.

Opt-in at ``load_clip`` time via ``$PROTOCLIP_AUTO_DOWNLOAD=1`` — zero-egress
deployments skip straight to the local-weights/random-init path without
waiting on network timeouts.
"""

from __future__ import annotations

import hashlib
import os
import sys
import urllib.request
import uuid
from typing import Optional

# SHA256-pinned release URLs (public constants, ref clip/clip.py:30-39)
MODEL_URLS = {
    "RN50": "https://openaipublic.azureedge.net/clip/models/afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762/RN50.pt",
    "RN101": "https://openaipublic.azureedge.net/clip/models/8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599/RN101.pt",
    "RN50x4": "https://openaipublic.azureedge.net/clip/models/7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd/RN50x4.pt",
    "RN50x16": "https://openaipublic.azureedge.net/clip/models/52378b407f34354e150460fe41077663dd5b39c54cd0bfd2b27167a4a06ec9aa/RN50x16.pt",
    "ViT-B/32": "https://openaipublic.azureedge.net/clip/models/40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt",
    "ViT-B/16": "https://openaipublic.azureedge.net/clip/models/5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f/ViT-B-16.pt",
    "ViT-L/14": "https://openaipublic.azureedge.net/clip/models/b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836/ViT-L-14.pt",
}


class ChecksumError(RuntimeError):
    """A downloaded artifact failed SHA-256 verification.

    Deliberately NOT a subclass of OSError: callers that tolerate network
    failures (e.g. ``load_clip``'s opt-in auto-download) must still treat
    an integrity failure as fatal rather than fall back to random init."""


def _sha256_of(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download_url(url: str, root: str, expected_sha256: Optional[str] = None,
                 progress: bool = True) -> str:
    """Download ``url`` into ``root`` with streaming SHA-256 verification.

    Returns the target path; reuses an existing file whose checksum matches.
    """
    os.makedirs(root, exist_ok=True)
    filename = os.path.basename(url)
    if expected_sha256 is None:
        # OpenAI layout: .../<sha256>/<filename>
        expected_sha256 = url.split("/")[-2]
        if len(expected_sha256) != 64:
            expected_sha256 = None
    target = os.path.join(root, filename)

    if os.path.exists(target) and not os.path.isfile(target):
        raise RuntimeError(f"{target} exists and is not a regular file")
    if os.path.isfile(target):
        if expected_sha256 is None or _sha256_of(target) == expected_sha256:
            return target
        # diagnostics go to stderr: stdout may carry a result line
        print(f"[protoclip_tpu_torch] {target} checksum mismatch; re-downloading",
              file=sys.stderr)

    # unique temp per writer: a SHARED <target>.part would let two
    # concurrent downloaders interleave writes into one file while each
    # hashes its own intact network stream — the winner would then
    # os.replace interleaved garbage into place as "verified"
    tmp = f"{target}.part-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    hasher = hashlib.sha256()
    # timeout so an opted-in auto-download can't hang startup on a stalled
    # connection; the caller falls back to local lookup/random init
    try:
        with urllib.request.urlopen(url, timeout=30) as source, open(tmp, "wb") as out:
            total = source.info().get("Content-Length")
            done = 0
            while True:
                buf = source.read(1 << 20)
                if not buf:
                    break
                hasher.update(buf)
                out.write(buf)
                done += len(buf)
                if progress and total:
                    pct = 100.0 * done / max(int(total), 1)
                    print(f"\r[protoclip_tpu_torch] downloading {filename}: {pct:5.1f}%",
                          end="", file=sys.stderr)
            if progress and total:
                print(file=sys.stderr)
        if expected_sha256 is not None and hasher.hexdigest() != expected_sha256:
            raise ChecksumError(
                f"downloaded {url} but SHA-256 {hasher.hexdigest()} != {expected_sha256}"
            )
    except BaseException:
        try:  # unique temps must not accumulate on failed downloads
            os.unlink(tmp)
        except OSError:
            pass
        raise
    os.replace(tmp, target)  # atomic: no torn cache entries
    return target


def extract_archive(path: str, dest: str) -> None:
    """Extract a ``.tar[.gz/.bz2/.xz]`` or ``.zip`` archive into ``dest``.

    The reference tries ``tarfile.open`` and falls back to zip on *any*
    exception (``datasets/utils.py:203-211``); here the format is sniffed
    explicitly and extraction is hardened: tar members go through the
    stdlib ``data`` filter (no absolute paths, no ``..`` escapes, no
    device nodes) and zipfile's own member sanitization covers the rest.
    """
    import tarfile
    import zipfile

    if tarfile.is_tarfile(path):
        with tarfile.open(path) as tar:
            tar.extractall(path=dest, filter="data")
    elif zipfile.is_zipfile(path):
        with zipfile.ZipFile(path, "r") as zf:
            zf.extractall(dest)
    else:
        raise ValueError(f"{path} is neither a tar archive nor a zip file")


def download_and_extract(
    url: str,
    root: str,
    expected_sha256: Optional[str] = None,
    progress: bool = True,
    keep_archive: bool = True,
) -> str:
    """Download an archive into ``root`` and extract it there.

    Counterpart of the reference's gdown-based
    ``DatasetBase.download_data`` (``datasets/utils.py:193-213``), built on
    the same streaming-hash + atomic-rename machinery as the weight
    downloader, so interrupted downloads never leave a torn archive.
    Returns ``root``.  ``file://`` URLs work (used by tests and air-gapped
    mirrors).  Like ``download_data`` this is an explicit call — dataset
    construction itself never touches the network (zero-egress images must
    not stall on timeouts).
    """
    target = download_url(url, root, expected_sha256, progress)
    extract_archive(target, root)
    if not keep_archive:
        os.remove(target)
    return root


def download_weights(backbone: str, root: Optional[str] = None) -> str:
    """Download the pinned release weights for ``backbone`` (ref
    ``clip/clip.py:42-70``) into ``root`` (default ``~/.cache/clip``)."""
    if backbone not in MODEL_URLS:
        raise KeyError(f"no release URL for backbone {backbone!r}; have {sorted(MODEL_URLS)}")
    root = root or os.path.expanduser("~/.cache/clip")
    return download_url(MODEL_URLS[backbone], root)
