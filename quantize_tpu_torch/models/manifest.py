"""Checkpoint integrity manifest (a copy of ``quantize_tpu/models/manifest.py``).

The reference verifies every downloaded checkpoint against a sha256
embedded in its URL (``modelzoo/clip/clip.py:30-72``; torchvision does the
same for the CNN zoo). Weights arrive as user-provided files — the
manifest brings back the same guarantee: ``cfg.model.torch_checkpoint_sha256``
pins a digest (hard fail on mismatch), or ``"auto"`` looks the model up in
the known-checkpoint table below.

``CLIP_SHA256`` holds the PUBLISHED OpenAI release digests (the constants
from the reference's ``_MODELS`` URLs — public data, required to match to
be useful). torchvision CNN digests are version-dependent; pin those
explicitly per deployment.
"""
from __future__ import annotations

import hashlib
from typing import Optional

# published OpenAI CLIP checkpoint digests (reference clip.py:30-40)
CLIP_SHA256 = {
    "clip_rn50": "afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762",
    "clip_rn101": "8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599",
    "clip_rn50x4": "7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd",
    "clip_rn50x16": "52378b407f34354e150460fe41077663dd5b39c54cd0bfd2b27167a4a06ec9aa",
    "clip_rn50x64": "be1cfb55d75a9666199fb2206c106743da0f6468c9d327f3e0d0a543a9919d9c",
    "clip_vit-b32": "40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af",
    "clip_vit-b16": "5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f",
    "clip_vit-l14": "b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836",
    "clip_vit-l14-336px": "3035c92b350959924f9f00213499208652fc7ea050643e8b385c2dac08641f02",
}


def sha256_of(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def lookup(model_name: str) -> Optional[str]:
    return CLIP_SHA256.get(model_name.lower())


def verify_checkpoint(path: str, expected: str,
                      model_name: str = "") -> None:
    """``expected``: a hex digest, or ``"auto"`` to consult the manifest.

    Raises ValueError on mismatch; ``"auto"`` with no manifest entry is a
    no-op (torchvision digests are deployment-pinned, not vendored).
    """
    if expected == "auto":
        expected = lookup(model_name)  # type: ignore[assignment]
        if expected is None:
            return
    got = sha256_of(path)
    if got != expected.lower():
        raise ValueError(
            f"checkpoint {path} sha256 mismatch: got {got}, expected "
            f"{expected} — refusing to load (reference parity: "
            f"clip.py:64-72 re-downloads on mismatch; here the file is "
            f"user-provided, so verify its provenance)")
