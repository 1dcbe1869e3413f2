"""Open-vocabulary segmentation behind the perception seam: the port of
adaptigraph_tpu/planning/segmentation.py.

The reference segments the tabletop object with GroundingDINO (open-vocab
box detection) + SAM (box-prompted masks) + IoU dedupe
(src/planning/perception.py:24-148). This module provides the same stage as
a `segmenter` callable for `PerceptionModule`:

  * `GroundingSAMSegmenter` — the full pipeline. The detector and SAM
    predictor are INJECTABLE (duck-typed), so the pipeline logic is testable
    without checkpoints; `from_checkpoints` builds the real torch models and
    is gated on the groundingdino / segment_anything packages + weights
    being present (the same availability-gating pattern as the
    pyrealsense2 camera backend in planning/real_world/cameras.py). The
    weights are not in this repository, so without them it raises and
    names what is missing.
  * `iou_dedupe` — mask suppression (perception.py:110-148's rule).
  * `depth_mask_segmenter` (in perception.py) remains the CI-safe default.

Detector contract:  detector(rgb_uint8) -> (boxes_xyxy (N, 4) float pixels,
scores (N,), phrases list[str]).
Predictor contract: predictor.set_image(rgb_uint8);
predictor.predict(box=xyxy) -> (H, W) bool mask.
"""

from __future__ import annotations

import os

import numpy as np


def mask_iou(a: np.ndarray, b: np.ndarray) -> float:
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return float(inter) / max(float(union), 1.0)


def iou_dedupe(masks, scores, iou_thresh: float = 0.9):
    """Drop masks that duplicate a higher-scoring mask (IoU above thresh) —
    the reference's duplicate-detection filter (perception.py:110-148).
    Returns indices of kept masks, best first."""
    order = np.argsort(-np.asarray(scores))
    keep = []
    for i in order:
        if all(mask_iou(masks[i], masks[j]) < iou_thresh for j in keep):
            keep.append(int(i))
    return keep


class GroundingSAMSegmenter:
    """detect (open-vocab) -> box-prompt SAM -> IoU dedupe -> union mask.

    Matches `PerceptionModule`'s segmenter signature. `table_prompts`
    detections are excluded from the union (the reference queries
    "table" alongside the object and drops it, perception.py:68-107)."""

    def __init__(self, detector, sam_predictor, prompts=("deformable object",),
                 table_prompts=("table",), box_threshold: float = 0.3,
                 iou_thresh: float = 0.9):
        self.detector = detector
        self.sam = sam_predictor
        self.prompts = tuple(p.lower() for p in prompts)
        self.table_prompts = tuple(p.lower() for p in table_prompts)
        self.box_threshold = box_threshold
        self.iou_thresh = iou_thresh

    def __call__(self, color, depth_m, table_height, intr, extr):
        rgb = np.asarray(color)
        if rgb.dtype != np.uint8:
            rgb = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        h, w = depth_m.shape
        boxes, scores, phrases = self.detector(rgb)
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        scores = np.asarray(scores, np.float32).reshape(-1)
        sel = scores >= self.box_threshold
        boxes, scores = boxes[sel], scores[sel]
        phrases = [p for p, s in zip(phrases, np.asarray(sel)) if s]
        if len(boxes) == 0:
            return np.zeros((h, w), bool)
        self.sam.set_image(rgb)
        masks, kept_scores, is_obj = [], [], []
        for box, score, phrase in zip(boxes, scores, phrases):
            m = np.asarray(self.sam.predict(box=box)).astype(bool)
            masks.append(m)
            kept_scores.append(score)
            is_obj.append(not any(t in phrase.lower() for t in self.table_prompts))
        keep = iou_dedupe(masks, kept_scores, self.iou_thresh)
        out = np.zeros((h, w), bool)
        for i in keep:
            if is_obj[i]:
                out |= masks[i]
        # depth-validity intersection: SAM masks can bleed into 0-depth pixels
        return out & (np.asarray(depth_m) > 0)

    @classmethod
    def from_checkpoints(cls, gdino_config: str, gdino_ckpt: str, sam_ckpt: str,
                         prompts=("deformable object",), device: str = "cpu",
                         **kw):
        """Build the real torch-backed pipeline. Requires the groundingdino
        and segment_anything packages plus downloaded weights — gated, not
        vendored (zero-egress environments keep the depth-mask default)."""
        for p in (gdino_config, gdino_ckpt, sam_ckpt):
            if not os.path.exists(p):
                raise FileNotFoundError(
                    f"checkpoint not found: {p}. GroundingSAMSegmenter needs "
                    "the GroundingDINO config and weights and the SAM "
                    "weights, which this repository does not hold; "
                    "perception.depth_mask_segmenter is the default "
                    "segmenter without them")
        try:
            from groundingdino.util.inference import load_model, predict
            import groundingdino.datasets.transforms as T
            from segment_anything import SamPredictor, sam_model_registry
        except ImportError as e:  # pragma: no cover - env without the pkgs
            raise ImportError(
                "GroundingSAMSegmenter.from_checkpoints needs the "
                "groundingdino and segment_anything packages, which are not "
                f"installed: {e}") from e

        from PIL import Image

        gdino = load_model(gdino_config, gdino_ckpt).to(device)
        sam = sam_model_registry["default"](checkpoint=sam_ckpt).to(device)
        sam_pred = SamPredictor(sam)
        caption = ". ".join(prompts)
        tfm = T.Compose([T.RandomResize([800], max_size=1333), T.ToTensor(),
                         T.Normalize([0.485, 0.456, 0.406],
                                     [0.229, 0.224, 0.225])])

        def detector(rgb):
            img, _ = tfm(Image.fromarray(rgb), None)
            boxes, logits, phrases = predict(
                model=gdino, image=img, caption=caption,
                box_threshold=kw.get("box_threshold", 0.3),
                text_threshold=0.25, device=device)
            h, w = rgb.shape[:2]
            # cxcywh normalized -> xyxy pixels
            b = boxes.numpy() * np.array([w, h, w, h])
            xyxy = np.stack([b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2,
                             b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2], 1)
            return xyxy, logits.numpy(), list(phrases)

        class _Pred:
            def set_image(self, rgb):
                sam_pred.set_image(rgb)

            def predict(self, box):
                masks, scores, _ = sam_pred.predict(
                    box=np.asarray(box)[None], multimask_output=False)
                return masks[0]

        return cls(detector, _Pred(), prompts=prompts, **kw)
