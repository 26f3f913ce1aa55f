"""Stage 4: semantic segmentation masks (Mask2Former, cityscapes); port of
`mtgs_tpu/preprocess/semantic_masks.py`.

Counterpart of `nuplan_scripts/generate_semantic_mask.py` +
the cityscapes label constants of `nuplan_scripts/utils/constants.py`
(OpenDriveLab/MTGS). The model is HF
`facebook/mask2former-swin-large-cityscapes-semantic`; its weights must
already be cached under HF_HOME — `mask2former_available()` probes for
that and the driver degrades to an explanatory error instead of a
download attempt. Without the cached weights the stage stays gated, as in
the JAX package.
Images are read with `data/image_io.read_image` and label maps written
with `tools/render.write_png` (no PIL).

The label map below is the contract consumed downstream
(`mtgs_torch/data/dataset.py` class masks: pedestrian/bicycle/vehicle ids,
background classes < 10 kept for the RGB point-cloud stacking).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, List, Optional

import numpy as np

# cityscapes trainId palette (ref constants.py:23-43)
CITYSCAPE_LABELS = {
    0: "road", 1: "sidewalk", 2: "building", 3: "wall", 4: "fence",
    5: "pole", 6: "traffic light", 7: "traffic sign", 8: "vegetation",
    9: "terrain", 10: "sky", 11: "person", 12: "rider", 13: "car",
    14: "truck", 15: "bus", 16: "train", 17: "motorcycle", 18: "bicycle",
}
SKY_ID = 10
PERSON_IDS = (11, 12)
VEHICLE_IDS = (13, 14, 15, 16)
BICYCLE_IDS = (17, 18)
# classes < 10 are static background: kept when stacking the RGB cloud
STATIC_BACKGROUND_MAX_ID = 10

_MODEL_NAME = "facebook/mask2former-swin-large-cityscapes-semantic"


def mask2former_available() -> bool:
    """True iff transformers + locally cached weights exist."""
    try:
        from transformers.utils import cached_file

        cached_file(_MODEL_NAME, "config.json", local_files_only=True)
        return True
    except Exception:
        return False


class SemanticMasker:
    """Batched semantic segmentation to uint8 label PNGs."""

    def __init__(self, device="cuda"):
        if not mask2former_available():
            raise RuntimeError(
                f"{_MODEL_NAME} weights are not cached locally and this "
                "environment has no network egress; pre-populate HF_HOME "
                "to run the semantic-mask stage."
            )
        import torch
        from transformers import AutoImageProcessor, Mask2FormerForUniversalSegmentation

        from mtgs_torch import resolve_device

        device = resolve_device(device)

        self.torch = torch
        self.processor = AutoImageProcessor.from_pretrained(
            _MODEL_NAME, local_files_only=True
        )
        self.model = Mask2FormerForUniversalSegmentation.from_pretrained(
            _MODEL_NAME, local_files_only=True
        ).to(device).eval()
        self.device = device

    def segment(self, images: List[np.ndarray]) -> List[np.ndarray]:
        """[H, W, 3] uint8 images -> [H, W] uint8 cityscapes label maps."""
        inputs = self.processor(images=images, return_tensors="pt").to(self.device)
        with self.torch.no_grad():
            out = self.model(**inputs)
        maps = self.processor.post_process_semantic_segmentation(
            out, target_sizes=[im.shape[:2] for im in images]
        )
        return [m.cpu().numpy().astype(np.uint8) for m in maps]


def generate_semantic_masks(
    image_paths: Iterable[str | Path],
    out_dir: str | Path,
    *,
    batch_size: int = 4,
    device="cuda",
    suffix: str = "_cityscape.png",
) -> List[Path]:
    """Run the masker over images, writing `<stem><suffix>` label PNGs
    (the layout `mtgs_torch/data/dataset.py` reads)."""
    from mtgs_torch.data.image_io import read_image, to_rgb
    from mtgs_torch.tools.render import write_png

    masker = SemanticMasker(device=device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = [Path(p) for p in image_paths]
    written = []
    for i in range(0, len(paths), batch_size):
        chunk = paths[i: i + batch_size]
        imgs = [to_rgb(read_image(p)) for p in chunk]
        for p, m in zip(chunk, masker.segment(imgs)):
            out = out_dir / (p.stem + suffix)
            write_png(out, m)
            written.append(out)
    return written


def class_mask(labels: np.ndarray, ids: Iterable[int]) -> np.ndarray:
    """[H, W] label map -> bool mask of the given class ids."""
    return np.isin(labels, np.asarray(list(ids)))
