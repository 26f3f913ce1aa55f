"""Write tests/fixtures/jpeg_manifest.json: the SHA-256 of PIL's JPEG
encodings of seeded uint8 arrays.

`mtgs_torch.data.image_io.write_jpeg` must write the bytes PIL writes for
`Image.fromarray(img).save(path)` to a .jpg path (quality 75, 4:2:0), and
`encode_jpeg(img, quality=85)` the bytes of `save(..., quality=85)` (the
viewer's frames). Where no PIL is installed (the machine with the card),
`chip_smoke.py` remakes the arrays with `make_array` (numpy only, integer
arithmetic) and holds the encoder's bytes against the hashes here. Each
entry: name, kind ("noise" or "gradient"), seed, shape [H, W, 3], sha256 and
size of PIL's file at its default quality, and under "q85" those at quality
85.

Run from the repository root (needs PIL):  python tests/make_jpeg_manifest.py
The manifest is regenerated bit for bit.
"""

from __future__ import annotations

import hashlib
import io
import json
from pathlib import Path

import numpy as np

MANIFEST = Path(__file__).resolve().parent / "fixtures" / "jpeg_manifest.json"

# width x height in the names, as image sizes are usually given
ARRAYS = [
    dict(name="noise_8x8", kind="noise", seed=0, shape=[8, 8, 3]),
    dict(name="noise_37x45", kind="noise", seed=1, shape=[45, 37, 3]),
    dict(name="noise_961x541", kind="noise", seed=2, shape=[541, 961, 3]),
    dict(name="gradient_1920x1080", kind="gradient", seed=3, shape=[1080, 1920, 3]),
]


def make_array(entry: dict) -> np.ndarray:
    """The uint8 array of a manifest entry, from its seed: uniform noise, or
    smooth integer ramps (x, y and x + y, in a seeded channel order)."""
    rng = np.random.default_rng(entry["seed"])
    h, w, c = entry["shape"]
    if entry["kind"] == "noise":
        return rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    y, x = np.mgrid[0:h, 0:w].astype(np.int64)
    ramps = [x * 255 // (w - 1), y * 255 // (h - 1), (x + y) * 255 // (w + h - 2)]
    order = rng.permutation(3)
    return np.stack([ramps[i] for i in order], -1).astype(np.uint8)


def pil_jpeg(img: np.ndarray, quality=None) -> bytes:
    """PIL's JPEG file of `img`, at its default quality unless one is given."""
    from PIL import Image

    buf = io.BytesIO()
    kw = {} if quality is None else dict(quality=quality)
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def manifest() -> dict:
    from PIL import __version__ as pil_version

    entries = []
    for e in ARRAYS:
        img = make_array(e)
        data, q85 = pil_jpeg(img), pil_jpeg(img, quality=85)
        entries.append(dict(e, sha256=hashlib.sha256(data).hexdigest(), bytes=len(data),
                            q85=dict(sha256=hashlib.sha256(q85).hexdigest(), bytes=len(q85))))
    return dict(encoder=f"PIL {pil_version}, Image.fromarray(img).save(path) to .jpg",
                arrays=entries)


if __name__ == "__main__":
    MANIFEST.write_text(json.dumps(manifest(), indent=1) + "\n")
    print(f"wrote {MANIFEST}")
