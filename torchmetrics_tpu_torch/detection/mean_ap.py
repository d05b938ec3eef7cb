"""MeanAveragePrecision: COCO mAP evaluated on the metric's device (port of ``torchmetrics_tpu/detection/mean_ap.py``).

States are per-image append lists (``dist_reduce_fx=None``), the reference's
nine list states. ``compute`` concatenates each state once and scatters it into
bucketed ``(images, slots)`` arrays on the device (the same buckets as the JAX
package), runs ``functional/detection/_map_eval.py`` there, and reads the small
``(T, R, C, A, M)`` precision and ``(T, C, A, M)`` recall arrays to the host
once for ``summarize``. The host also reads the class list and the deepest
per-(image, class) stack, which picks the matcher.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.detection.helpers import (
    _as_tensor,
    _fix_empty_tensors,
    _input_validator,
    _validate_iou_type_arg,
)
from torchmetrics_tpu_torch.functional.detection._map_eval import evaluate_map, summarize
from torchmetrics_tpu_torch.functional.detection._pairwise import box_area, box_convert, pairwise_mask_iou_crowd
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import _bucket_size as _bucket
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

_STAT_KEYS = ("map", "map_50", "map_75", "map_small", "map_medium", "map_large", "mar_small", "mar_medium", "mar_large")


class _Padded:
    """Per-image rows of a list state scattered into ``(images, slots, ...)``: one index for every state of a side."""

    def __init__(self, counts: Sequence[int], device: torch.device) -> None:
        self.counts = np.asarray(counts, np.int64)
        self.width = _bucket(max([*counts, 1]))
        starts = np.repeat(np.cumsum(self.counts) - self.counts, self.counts)
        rows = np.repeat(np.arange(len(counts)) * self.width, self.counts) + np.arange(int(self.counts.sum())) - starts
        self.rows = torch.as_tensor(rows, device=device)
        self.valid = torch.arange(self.width, device=device)[None, :] < torch.as_tensor(self.counts, device=device)[:, None]

    def __call__(self, chunks: List[Tensor], dtype: torch.dtype, trailing: Tuple[int, ...] = ()) -> Tensor:
        out = torch.zeros((len(self.counts) * self.width, *trailing), dtype=dtype, device=self.rows.device)
        if self.rows.numel():
            out[self.rows] = torch.cat([c.reshape(-1, *trailing) for c in chunks]).to(dtype)
        return out.reshape(len(self.counts), self.width, *trailing)


class MeanAveragePrecision(Metric):
    """Mean Average Precision / Recall for object detection (COCO protocol).

    Inputs follow the reference protocol: ``update(preds, target)`` with lists
    of per-image dicts carrying ``boxes``/``masks``, ``scores``, ``labels``
    (plus optional ``iscrowd``, ``area`` on targets). Output keys match the
    reference: ``map``, ``map_50``, ``map_75``, ``map_small/medium/large``,
    ``mar_{k}`` per max-detection threshold, ``mar_small/medium/large``,
    ``map_per_class``, ``mar_{k}_per_class``, ``classes``, with ``-1``
    sentinels where undefined.

    ``iou_type="segm"`` operates on dense boolean masks ``(N, H, W)``; mask
    IoU is one matrix product per image.

    ``backend`` keeps the JAX package's values: the default (``"xla"``)
    evaluates on the metric's device, and the host backends
    (``pycocotools`` / ``faster_coco_eval``) are only consulted by the
    ``coco``/``cocoeval``/``mask_utils`` properties, which raise
    ``ModuleNotFoundError`` when the package is not installed.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.detection import MeanAveragePrecision
        >>> preds = [dict(boxes=torch.tensor([[258.0, 41.0, 606.0, 285.0]]),
        ...               scores=torch.tensor([0.536]), labels=torch.tensor([0]))]
        >>> target = [dict(boxes=torch.tensor([[214.0, 41.0, 562.0, 285.0]]),
        ...                labels=torch.tensor([0]))]
        >>> metric = MeanAveragePrecision(iou_type="bbox", device="cpu")
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()["map"]), 4)
        0.6
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = True
    full_state_update: bool = True

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_type: Union[str, Tuple[str, ...]] = "bbox",
        iou_thresholds: Optional[List[float]] = None,
        rec_thresholds: Optional[List[float]] = None,
        max_detection_thresholds: Optional[List[int]] = None,
        class_metrics: bool = False,
        extended_summary: bool = False,
        average: str = "macro",
        backend: str = "xla",
        warn_on_many_detections: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)

        allowed_box_formats = ("xyxy", "xywh", "cxcywh")
        if box_format not in allowed_box_formats:
            raise ValueError(f"Expected argument `box_format` to be one of {allowed_box_formats} but got {box_format}")
        self.box_format = box_format
        self.iou_type = _validate_iou_type_arg(iou_type)

        if iou_thresholds is not None and not isinstance(iou_thresholds, list):
            raise ValueError(
                f"Expected argument `iou_thresholds` to either be `None` or a list of floats but got {iou_thresholds}"
            )
        self.iou_thresholds = iou_thresholds or np.linspace(0.5, 0.95, 10).round(2).tolist()

        if rec_thresholds is not None and not isinstance(rec_thresholds, list):
            raise ValueError(
                f"Expected argument `rec_thresholds` to either be `None` or a list of floats but got {rec_thresholds}"
            )
        self.rec_thresholds = rec_thresholds or np.linspace(0.0, 1.00, 101).round(2).tolist()

        if max_detection_thresholds is not None and not isinstance(max_detection_thresholds, list):
            raise ValueError(
                "Expected argument `max_detection_thresholds` to either be `None` or a list of ints"
                f" but got {max_detection_thresholds}"
            )
        self.max_detection_thresholds = sorted(max_detection_thresholds or [1, 10, 100])

        if not isinstance(class_metrics, bool):
            raise ValueError("Expected argument `class_metrics` to be a boolean")
        self.class_metrics = class_metrics
        if not isinstance(extended_summary, bool):
            raise ValueError("Expected argument `extended_summary` to be a boolean")
        self.extended_summary = extended_summary
        if average not in ("macro", "micro"):
            raise ValueError(f"Expected argument `average` to be one of ('macro', 'micro') but got {average}")
        self.average = average
        self.backend = backend
        self.warn_on_many_detections = warn_on_many_detections

        self.add_state("detection_box", default=[], dist_reduce_fx=None)
        self.add_state("detection_mask", default=[], dist_reduce_fx=None)
        self.add_state("detection_scores", default=[], dist_reduce_fx=None)
        self.add_state("detection_labels", default=[], dist_reduce_fx=None)
        self.add_state("groundtruth_box", default=[], dist_reduce_fx=None)
        self.add_state("groundtruth_mask", default=[], dist_reduce_fx=None)
        self.add_state("groundtruth_labels", default=[], dist_reduce_fx=None)
        self.add_state("groundtruth_crowds", default=[], dist_reduce_fx=None)
        self.add_state("groundtruth_area", default=[], dist_reduce_fx=None)

    def update(self, preds: List[Dict[str, Tensor]], target: List[Dict[str, Tensor]]) -> None:
        """Append per-image detections and ground truths to the states."""
        _input_validator(preds, target, iou_type=self.iou_type)

        for item in preds:
            bbox, mask = self._get_safe_item_values(item, warn=self.warn_on_many_detections)
            if bbox is not None:
                self.detection_box.append(bbox)
            if mask is not None:
                self.detection_mask.append(mask)
            self.detection_labels.append(_as_tensor(item["labels"], torch.int32, self.device))
            self.detection_scores.append(_as_tensor(item["scores"], torch.float32, self.device))

        for item in target:
            bbox, mask = self._get_safe_item_values(item)
            if bbox is not None:
                self.groundtruth_box.append(bbox)
            if mask is not None:
                self.groundtruth_mask.append(mask)
            labels = _as_tensor(item["labels"], torch.int32, self.device)
            self.groundtruth_labels.append(labels)
            crowds, area = item.get("iscrowd"), item.get("area")
            n = labels.shape[0]
            self.groundtruth_crowds.append(
                torch.zeros(n, dtype=torch.int32, device=self.device) if crowds is None
                else _as_tensor(crowds, torch.int32, self.device)
            )
            self.groundtruth_area.append(
                torch.zeros(n, dtype=torch.float32, device=self.device) if area is None
                else _as_tensor(area, torch.float32, self.device)
            )

    def _get_safe_item_values(self, item: Dict[str, Tensor], warn: bool = False) -> Tuple[Optional[Tensor], Optional[Tensor]]:
        output: List[Optional[Tensor]] = [None, None]
        if "bbox" in self.iou_type:
            boxes = _fix_empty_tensors(_as_tensor(item["boxes"], torch.float32, self.device))
            if boxes.numel() > 0:
                boxes = box_convert(boxes, in_fmt=self.box_format, out_fmt="xyxy")
            output[0] = boxes
        if "segm" in self.iou_type:
            output[1] = _as_tensor(item["masks"], torch.bool, self.device)
        if warn and any(o is not None and len(o) > self.max_detection_thresholds[-1] for o in output):
            rank_zero_warn(
                f"Encountered more than {self.max_detection_thresholds[-1]} detections in a single image."
                " This means that certain detections with the lowest scores will be ignored, that may have"
                " an undesirable impact on performance. Please consider adjusting the `max_detection_threshold`"
                " to suit your use case.",
                UserWarning,
            )
        return output[0], output[1]

    def _get_classes(self) -> List[int]:
        """Union of the classes seen in detections and ground truths, sorted (one host read)."""
        labels = [x.reshape(-1) for x in (*self.detection_labels, *self.groundtruth_labels)]
        if not labels:
            return []
        return torch.unique(torch.cat(labels)).tolist()

    # ------------------------------------------------------------------ #
    # compute                                                            #
    # ------------------------------------------------------------------ #

    def _padded_arrays(self, micro: bool, iou_t: str) -> Dict[str, Any]:
        """The list states as bucketed ``(I, D[, ...])`` / ``(I, G[, ...])`` arrays on the device.

        Areas follow the evaluation type: box areas for ``bbox``, mask pixel
        counts for ``segm`` (this matters when both iou types are requested).
        """
        dets = _Padded([x.shape[0] for x in self.detection_labels], self.device)
        gts = _Padded([x.shape[0] for x in self.groundtruth_labels], self.device)
        out = {"det_scores": dets(self.detection_scores, torch.float32), "det_valid": dets.valid,
               "gt_valid": gts.valid, "gt_crowd": gts(self.groundtruth_crowds, torch.bool)}
        if iou_t == "bbox":
            out["det_boxes"] = dets(self.detection_box, torch.float32, (4,))
            out["gt_boxes"] = gts(self.groundtruth_box, torch.float32, (4,))
            out["det_area"] = box_area(out["det_boxes"])
            default_area = box_area(out["gt_boxes"])
        else:
            pixels = lambda masks: [m.reshape(m.shape[0], -1).sum(dim=1) for m in masks]  # noqa: E731
            out["det_area"] = dets(pixels(self.detection_mask), torch.float32)
            default_area = gts(pixels(self.groundtruth_mask), torch.float32)
            out["det_boxes"] = torch.zeros((*out["det_area"].shape, 4), device=self.device)
            out["gt_boxes"] = torch.zeros((*default_area.shape, 4), device=self.device)
        provided = gts(self.groundtruth_area, torch.float32)
        out["gt_area"] = torch.where(provided > 0, provided, default_area)
        if micro:
            out["det_labels"] = torch.zeros(out["det_valid"].shape, dtype=torch.int32, device=self.device)
            out["gt_labels"] = torch.zeros(out["gt_valid"].shape, dtype=torch.int32, device=self.device)
        else:
            out["det_labels"] = dets(self.detection_labels, torch.int32)
            out["gt_labels"] = gts(self.groundtruth_labels, torch.int32)
        return out

    def _mask_iou_override(self, num_d: int, num_g: int, gt_crowd: Tensor) -> Tensor:
        """Per-image dense-mask IoU matrices, padded to ``(I, D, G)``."""
        out = torch.zeros((len(self.detection_labels), num_d, num_g), device=self.device)
        for i, (dm, gm) in enumerate(zip(self.detection_mask, self.groundtruth_mask)):
            if dm.shape[0] and gm.shape[0]:
                out[i, : dm.shape[0], : gm.shape[0]] = pairwise_mask_iou_crowd(dm, gm, gt_crowd[i, : gm.shape[0]])
        return out

    def _run_eval(self, iou_t: str, micro: bool, classes: List[int]) -> Tuple[Tensor, Tensor, Tensor]:
        arrays = self._padded_arrays(micro, iou_t)
        classes = [0] if micro else classes
        num_classes = len(classes) if classes else 1
        dl, dv = arrays["det_labels"], arrays["det_valid"]
        # remap sparse label ids to dense [0, C) so the rank and match tensors stay O(C) for large raw ids
        if not micro and classes:
            table = torch.tensor(classes, dtype=torch.int32, device=self.device)
            dl = arrays["det_labels"] = torch.searchsorted(table, dl).to(torch.int32)
            arrays["gt_labels"] = torch.searchsorted(table, arrays["gt_labels"]).to(torch.int32)
        class_ids = torch.full((_bucket(max(num_classes, 1), minimum=4),), -1, dtype=torch.int32, device=self.device)
        class_ids[:num_classes] = torch.arange(num_classes, dtype=torch.int32, device=self.device)

        iou_override = None
        if iou_t == "segm":
            iou_override = self._mask_iou_override(dv.shape[1], arrays["gt_valid"].shape[1], arrays["gt_crowd"])

        # the deepest per-(image, class) stack, capped at max_detection_thresholds[-1]: the rank-stepped
        # matcher's depth (one host read)
        per_img_class = torch.zeros((dl.shape[0], num_classes), dtype=torch.int64, device=self.device)
        per_img_class.scatter_add_(1, torch.clamp(dl.long(), 0, num_classes - 1), dv.long())
        max_cr = int(torch.clamp_max(per_img_class.max(), self.max_detection_thresholds[-1]))

        return evaluate_map(
            arrays["det_boxes"], arrays["det_scores"], dl, dv, arrays["det_area"],
            arrays["gt_boxes"], arrays["gt_labels"], arrays["gt_valid"], arrays["gt_crowd"], arrays["gt_area"],
            class_ids,
            torch.tensor(self.iou_thresholds, dtype=torch.float32, device=self.device),
            torch.tensor(self.rec_thresholds, dtype=torch.float32, device=self.device),
            tuple(self.max_detection_thresholds),
            int(num_classes),
            iou_override=iou_override,
            max_class_rank=_bucket(max(max_cr, 1)),
        )

    def compute(self) -> Dict[str, Tensor]:
        """Run the COCO evaluation over all accumulated images on the metric's device."""
        result: Dict[str, Tensor] = {}
        last_m = len(self.max_detection_thresholds) - 1
        mdt_last = self.max_detection_thresholds[-1]
        if len(self.detection_labels) == 0 and len(self.groundtruth_labels) == 0:
            for i_type in self.iou_type:
                prefix = "" if len(self.iou_type) == 1 else f"{i_type}_"
                keys = [*_STAT_KEYS, "map_per_class", f"mar_{mdt_last}_per_class"]
                keys += [f"mar_{m}" for m in self.max_detection_thresholds]
                result.update({f"{prefix}{k}": torch.tensor(-1.0, device=self.device) for k in keys})
            result["classes"] = torch.zeros(0, dtype=torch.int32, device=self.device)
            return result
        classes = self._get_classes()
        for i_type in self.iou_type:
            prefix = "" if len(self.iou_type) == 1 else f"{i_type}_"
            precision, recall, scores = self._run_eval(i_type, micro=self.average == "micro", classes=classes)
            # the one transfer of the evaluation: precision and recall, read together
            flat = torch.cat([precision.reshape(-1), recall.reshape(-1)]).cpu().numpy()
            prec_np = flat[: precision.numel()].reshape(precision.shape)
            rec_np = flat[precision.numel() :].reshape(recall.shape)
            stats = summarize(prec_np, rec_np, self.iou_thresholds, self.max_detection_thresholds)
            values = torch.tensor(list(stats.values()), dtype=torch.float32).to(self.device)
            result.update({f"{prefix}{k}": values[j] for j, k in enumerate(stats)})

            if self.extended_summary:
                result.update({f"{prefix}precision": precision, f"{prefix}recall": recall, f"{prefix}scores": scores})

            if self.class_metrics:
                if self.average == "micro":
                    # per-class values still use the macro (per-label) evaluation
                    precision, recall, _ = self._run_eval(i_type, micro=False, classes=classes)
                    prec_np, rec_np = precision.cpu().numpy(), recall.cpu().numpy()
                map_pc, mar_pc = [], []
                for ci in range(len(classes)):
                    p = prec_np[:, :, ci, 0, last_m]
                    p = p[p > -1]
                    map_pc.append(float(p.mean()) if p.size else -1.0)
                    r = rec_np[:, ci, 0, last_m]
                    r = r[r > -1]
                    mar_pc.append(float(r.mean()) if r.size else -1.0)
                result[f"{prefix}map_per_class"] = torch.tensor(map_pc, dtype=torch.float32, device=self.device)
                result[f"{prefix}mar_{mdt_last}_per_class"] = torch.tensor(mar_pc, dtype=torch.float32, device=self.device)
            else:
                result[f"{prefix}map_per_class"] = torch.tensor(-1.0, device=self.device)
                result[f"{prefix}mar_{mdt_last}_per_class"] = torch.tensor(-1.0, device=self.device)

        result["classes"] = torch.tensor(classes, dtype=torch.int32, device=self.device)
        return result

    # ------------------------------------------------------- COCO interchange
    @property
    def coco(self) -> object:
        """The COCO dataset class of the host backend (reference ``mean_ap.py:452-456``)."""
        return _load_host_backend_tools(self.backend)[0]

    @property
    def cocoeval(self) -> object:
        """The COCOeval class of the host backend (reference ``mean_ap.py:458-462``)."""
        return _load_host_backend_tools(self.backend)[1]

    @property
    def mask_utils(self) -> object:
        """The RLE mask-utils module of the host backend (reference ``mean_ap.py:464-468``)."""
        return _load_host_backend_tools(self.backend)[2]

    @staticmethod
    def coco_to_tm(
        coco_preds: str,
        coco_target: str,
        iou_type: Union[str, Tuple[str, ...]] = "bbox",
        backend: str = "pycocotools",
    ) -> Tuple[List[Dict[str, Tensor]], List[Dict[str, Tensor]]]:
        """Convert COCO-format json files to this metric's input format (CPU tensors).

        Parses the json directly, so no C backend is required; masks are
        decoded with the port's RLE codec. Boxes are returned in the files'
        native ``xywh`` layout, like the reference.
        """
        import json

        from torchmetrics_tpu_torch.functional.detection._rle import ann_to_mask

        iou_type = _validate_iou_type_arg(iou_type)

        with open(coco_target) as f:
            gt_data = json.load(f)
        with open(coco_preds) as f:
            dt_data = json.load(f)
        gt_anns = gt_data["annotations"] if isinstance(gt_data, dict) else gt_data
        dt_anns = dt_data["annotations"] if isinstance(dt_data, dict) else dt_data
        img_sizes = {}
        if isinstance(gt_data, dict):
            for img in gt_data.get("images", []):
                img_sizes[img["id"]] = (img.get("height", 0), img.get("width", 0))

        def _mask(ann):
            h, w = img_sizes.get(ann["image_id"], (0, 0))
            return ann_to_mask(ann["segmentation"], h, w)

        def _empty_entry(with_scores: bool) -> Dict[str, list]:
            entry: Dict[str, list] = (
                {"scores": [], "labels": []} if with_scores else {"labels": [], "iscrowd": [], "area": []}
            )
            if "bbox" in iou_type:
                entry["boxes"] = []
            if "segm" in iou_type:
                entry["masks"] = []
            return entry

        target: Dict[Any, Dict[str, list]] = {}
        for t in gt_anns:
            entry = target.setdefault(t["image_id"], _empty_entry(with_scores=False))
            if "bbox" in iou_type:
                entry["boxes"].append(t["bbox"])
            if "segm" in iou_type:
                entry["masks"].append(_mask(t))
            entry["labels"].append(t["category_id"])
            entry["iscrowd"].append(t.get("iscrowd", 0))
            entry["area"].append(t.get("area", 0))

        preds: Dict[Any, Dict[str, list]] = {}
        for p in dt_anns:
            if p["image_id"] not in target:
                # mirror COCO.loadRes: predictions must correspond to the gt set
                raise ValueError(
                    f"Prediction for image_id {p['image_id']!r} does not correspond to any image in the"
                    " target file. Results do not correspond to the current coco set."
                )
            entry = preds.setdefault(p["image_id"], _empty_entry(with_scores=True))
            if "bbox" in iou_type:
                entry["boxes"].append(p["bbox"])
            if "segm" in iou_type:
                entry["masks"].append(_mask(p))
            entry["scores"].append(p["score"])
            entry["labels"].append(p["category_id"])
        for k in target:  # images without predictions get empty entries
            preds.setdefault(k, _empty_entry(with_scores=True))

        def _masks(masks: list) -> Tensor:
            return torch.from_numpy(np.stack(masks).astype(np.uint8)) if masks else torch.zeros((0, 0, 0), dtype=torch.uint8)

        def _array(values: list, dtype, shape=(-1,)) -> Tensor:
            return torch.from_numpy(np.asarray(values, dtype=dtype).reshape(shape))

        batched_preds, batched_target = [], []
        for key in target:
            bp = {"scores": _array(preds[key]["scores"], np.float32), "labels": _array(preds[key]["labels"], np.int32)}
            if "bbox" in iou_type:
                bp["boxes"] = _array(preds[key]["boxes"], np.float32, (-1, 4))
            if "segm" in iou_type:
                bp["masks"] = _masks(preds[key]["masks"])
            batched_preds.append(bp)
            bt = {
                "labels": _array(target[key]["labels"], np.int32),
                "iscrowd": _array(target[key]["iscrowd"], np.int32),
                "area": _array(target[key]["area"], np.float32),
            }
            if "bbox" in iou_type:
                bt["boxes"] = _array(target[key]["boxes"], np.float32, (-1, 4))
            if "segm" in iou_type:
                bt["masks"] = _masks(target[key]["masks"])
            batched_target.append(bt)
        return batched_preds, batched_target

    def tm_to_coco(self, name: str = "tm_map_input") -> None:
        """Dump the cached inputs as ``{name}_preds.json`` / ``{name}_target.json``.

        Call after ``update``/``forward``; boxes are written in COCO ``xywh``,
        masks as compressed RLE through the port's codec.
        """
        import json

        target_dataset = self._get_coco_format(
            labels=self.groundtruth_labels,
            boxes=self.groundtruth_box if "bbox" in self.iou_type else None,
            masks=self.groundtruth_mask if "segm" in self.iou_type else None,
            crowds=self.groundtruth_crowds,
            area=self.groundtruth_area,
        )
        preds_dataset = self._get_coco_format(
            labels=self.detection_labels,
            boxes=self.detection_box if "bbox" in self.iou_type else None,
            masks=self.detection_mask if "segm" in self.iou_type else None,
            scores=self.detection_scores,
        )
        with open(f"{name}_preds.json", "w") as f:
            f.write(json.dumps(preds_dataset["annotations"], indent=4))
        with open(f"{name}_target.json", "w") as f:
            f.write(json.dumps(target_dataset, indent=4))

    def _get_coco_format(
        self,
        labels: List[Tensor],
        boxes: Optional[List[Tensor]] = None,
        masks: Optional[List[Tensor]] = None,
        scores: Optional[List[Tensor]] = None,
        crowds: Optional[List[Tensor]] = None,
        area: Optional[List[Tensor]] = None,
    ) -> Dict[str, Any]:
        """Cached states → COCO dataset dict (reference ``mean_ap.py:842-940``). Box states are xyxy; COCO is xywh."""
        from torchmetrics_tpu_torch.functional.detection._rle import mask_to_rle_counts, rle_string_encode

        host = lambda x: x.cpu().numpy()  # noqa: E731
        images, annotations = [], []
        annotation_id = 1
        for image_id, image_labels in enumerate(labels):
            image_labels = host(image_labels).tolist()
            images.append({"id": image_id})
            image_boxes = None
            if boxes is not None and image_id < len(boxes):
                xyxy = host(boxes[image_id]).astype(np.float64).reshape(-1, 4)
                image_boxes = np.concatenate([xyxy[:, :2], xyxy[:, 2:] - xyxy[:, :2]], axis=1).tolist()
            image_masks = None
            if masks is not None and image_id < len(masks):
                image_masks = host(masks[image_id]).astype(np.uint8)
                if image_masks.size:
                    images[-1]["height"], images[-1]["width"] = int(image_masks.shape[-2]), int(image_masks.shape[-1])
            image_crowds = host(crowds[image_id]) if crowds is not None else None
            image_area = host(area[image_id]) if area is not None else None
            image_scores = host(scores[image_id]) if scores is not None else None
            for k, image_label in enumerate(image_labels):
                ann: Dict[str, Any] = {
                    "id": annotation_id,
                    "image_id": image_id,
                    "category_id": int(image_label),
                    "iscrowd": int(image_crowds[k]) if image_crowds is not None else 0,
                }
                stat_area = float(image_area[k]) if image_area is not None else 0.0
                if image_boxes is not None:
                    ann["bbox"] = [float(v) for v in image_boxes[k]]
                    if stat_area <= 0:
                        stat_area = ann["bbox"][2] * ann["bbox"][3]
                if image_masks is not None and len(image_masks):
                    m = image_masks[k]
                    ann["segmentation"] = {
                        "size": [int(m.shape[0]), int(m.shape[1])],
                        "counts": rle_string_encode(mask_to_rle_counts(m)),
                    }
                    if stat_area <= 0:
                        stat_area = float(m.sum())
                ann["area"] = stat_area
                if image_scores is not None:
                    ann["score"] = float(image_scores[k])
                annotations.append(ann)
                annotation_id += 1
        classes = [{"id": int(i), "name": str(i)} for i in self._get_classes()]
        return {"images": images, "annotations": annotations, "categories": classes}


def _load_host_backend_tools(backend: str) -> Tuple[object, object, object]:
    """Load (COCO, COCOeval, mask_utils) for a host backend (reference ``mean_ap.py:50-71``)."""
    if backend == "pycocotools":
        try:
            import pycocotools.mask as mask_utils
            from pycocotools.coco import COCO
            from pycocotools.cocoeval import COCOeval
        except ImportError as err:
            raise ModuleNotFoundError(
                "Backend `pycocotools` in metric `MeanAveragePrecision` requires that `pycocotools` is installed."
                " Please install with `pip install pycocotools`."
            ) from err
        return COCO, COCOeval, mask_utils
    if backend == "faster_coco_eval":
        try:
            from faster_coco_eval import COCO
            from faster_coco_eval import COCOeval_faster as COCOeval
            from faster_coco_eval.core import mask as mask_utils
        except ImportError as err:
            raise ModuleNotFoundError(
                "Backend `faster_coco_eval` in metric `MeanAveragePrecision` requires that `faster-coco-eval` is"
                " installed. Please install with `pip install faster-coco-eval`."
            ) from err
        return COCO, COCOeval, mask_utils
    raise ModuleNotFoundError(
        f"Backend `{backend}` evaluates on the metric's device and exposes no host COCO tools;"
        " construct the metric with backend='pycocotools' or 'faster_coco_eval' to use them."
    )
