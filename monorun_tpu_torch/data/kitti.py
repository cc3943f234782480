"""KITTI 3D dataset: annotation parsing, result formatting, evaluation.

Host-side (numpy) re-implementation of the reference dataset layer
(datasets/kitti3d_dataset.py):

* calib P2 -> K and the rectification offset ``cam_t_vec = K^-1 P[:, 3]``
  added to GT translations for the camera frame (and subtracted back when
  formatting results for the official eval, kitti3d_dataset.py:119-122,
  243);
* label parsing with hwl -> lhw reorder (:165) and DontCare ignore boxes;
* ``alpha = ry - atan2(x, z + 0.27)`` for submissions (:256);
* KITTI-format result writer (hwl order, :319);
* sparse LiDAR object-coordinate maps loaded from per-image pkl
  (pipelines/loading.py:28-50) kept sparse for the fixed-shape batches.

The port's copy of ``monorun_tpu/data/kitti.py`` (numpy only).
"""

from __future__ import annotations

import os
import os.path as osp
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import DataConfig

KITTI_CLASSES = ("Car", "Pedestrian", "Cyclist")


def read_calib(path: str, cam: int = 2) -> np.ndarray:
    """Return the 3x4 projection matrix for the requested camera."""
    with open(path) as f:
        line = f.readlines()[cam]
    vals = [float(v) for v in line.strip().split(" ")[1:]]
    return np.asarray(vals, np.float32).reshape(3, 4)


def read_label(path: str) -> List[list]:
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(" ")
            if not parts or parts[0] == "":
                continue
            rows.append(
                [parts[0], float(parts[1]), int(float(parts[2]))]
                + [float(v) for v in parts[3:]]
            )
    return rows


def decompose_calib(proj: np.ndarray):
    """P (3, 4) -> (K (3, 3), cam_t_vec (3,)) via triangular solve."""
    K = proj[:, :3]
    t = np.linalg.solve(K, proj[:, 3])
    return K, t.astype(np.float32)


class KITTI3DDataset:
    """File-list dataset with lazy per-index annotation parsing."""

    def __init__(
        self,
        root: str,
        list_file: str,
        classes: Sequence[str] = KITTI_CLASSES,
        with_labels: bool = True,
        coord_3d_prefix: Optional[str] = None,
        calib_cam: int = 2,
        meta_prefix: str = "img_metas",
    ):
        self.root = root
        self.classes = tuple(classes)
        self.with_labels = with_labels
        self.coord_3d_prefix = coord_3d_prefix
        self.calib_cam = calib_cam
        self.meta_prefix = meta_prefix
        with open(osp.join(root, list_file)) as f:
            self.ids = [ln.strip() for ln in f if ln.strip()]

    def __len__(self) -> int:
        return len(self.ids)

    def image_path(self, idx: int) -> str:
        return osp.join(self.root, "image_2", self.ids[idx] + ".png")

    def image_size(self, idx: int):
        """(h, w) from the prepared meta file, or by decoding the image."""
        meta = osp.join(self.root, self.meta_prefix, self.ids[idx] + ".txt")
        if osp.exists(meta):
            h, w = np.loadtxt(meta, delimiter=",")
            return int(h), int(w)
        import cv2

        img = cv2.imread(self.image_path(idx))
        return img.shape[0], img.shape[1]

    def get_ann(self, idx: int) -> Dict[str, np.ndarray]:
        name = self.ids[idx]
        proj = read_calib(
            osp.join(self.root, "calib", name + ".txt"), self.calib_cam
        )
        K, cam_t_vec = decompose_calib(proj)
        ann: Dict[str, np.ndarray] = dict(
            cam_intrinsic=K, cam_t_vec=cam_t_vec
        )
        if not self.with_labels:
            return ann

        rows = read_label(osp.join(self.root, "label_2", name + ".txt"))
        boxes, labels, boxes3d, ignore = [], [], [], []
        trunc, occ, alpha, obj_ids = [], [], [], []
        for oid, r in enumerate(rows):
            cls = r[0]
            if cls in self.classes:
                obj_ids.append(oid)
                labels.append(self.classes.index(cls))
                trunc.append(r[1])
                occ.append(r[2])
                alpha.append(r[3])
                boxes.append(r[4:8])
                boxes3d.append(r[8:15])
            elif cls.lower() == "dontcare":
                ignore.append(r[4:8])

        if boxes:
            boxes = np.asarray(boxes, np.float32)
            labels = np.asarray(labels, np.int64)
            boxes3d = np.asarray(boxes3d, np.float32)
            boxes3d[:, [0, 1, 2]] = boxes3d[:, [2, 0, 1]]   # hwl -> lhw
            obj_ids = np.asarray(obj_ids, np.int64)
        else:
            boxes = np.zeros((0, 4), np.float32)
            labels = np.zeros((0,), np.int64)
            boxes3d = np.zeros((0, 7), np.float32)
            obj_ids = np.zeros((0,), np.int64)

        boxes3d_eval = boxes3d.copy()           # reference (rectified) frame
        boxes3d = boxes3d.copy()
        boxes3d[:, 3:6] += cam_t_vec            # camera frame

        ann.update(
            object_ids=obj_ids,
            bboxes=boxes,
            labels=labels,
            bboxes_ignore=np.asarray(ignore, np.float32).reshape(-1, 4),
            truncation=np.asarray(trunc, np.float32),
            occlusion=np.asarray(occ, np.float32),
            alpha=np.asarray(alpha, np.float32),
            bboxes_3d=boxes3d,
            bboxes_3d_eval=boxes3d_eval,
        )
        return ann

    def get_sparse_coords(self, idx: int, object_ids: np.ndarray):
        """Per-object sparse LiDAR object-coordinate points (uv, oc)."""
        if self.coord_3d_prefix is None:
            return None
        path = osp.join(
            self.root, self.coord_3d_prefix, self.ids[idx] + ".pkl"
        )
        with open(path, "rb") as f:
            oc_dict = pickle.load(f)
        out = []
        for oid in object_ids:
            uv = np.asarray(oc_dict["uv_list"][oid], np.float32)
            oc = np.asarray(oc_dict["oc_list"][oid], np.float32)
            out.append((uv, oc))
        return out

    # ---- result formatting / evaluation -----------------------------------

    def format_results(
        self, results: List[Dict[str, np.ndarray]]
    ) -> List[Dict[str, np.ndarray]]:
        """Detections -> KITTI annotation dicts (kitti3d_dataset.py:230-270).

        Each result dict: bboxes_2d (M, 4), labels (M,), bboxes_3d (M, 8)
        [l,h,w,x,y,z,ry,score], valid (M,) — the fixed-shape detector
        output for one image.
        """
        det_annos = []
        empty = dict(
            name=np.asarray([], dtype=object),
            truncated=np.zeros(0, np.int8),
            occluded=np.zeros(0, np.int8),
            alpha=np.zeros(0, np.float32),
            bbox=np.zeros((0, 4), np.float32),
            dimensions=np.zeros((0, 3), np.float32),
            location=np.zeros((0, 3), np.float32),
            rotation_y=np.zeros(0, np.float32),
            score=np.zeros(0, np.float32),
        )
        for idx, res in enumerate(results):
            if res is None:
                # a distributed shard can under-cover (tail drop / missing
                # index): emit an empty annotation instead of crashing
                det_annos.append({k: v.copy() for k, v in empty.items()})
                continue
            ann = self.get_ann(idx)
            keep = np.asarray(res["valid"], bool)
            b2d = np.asarray(res["bboxes_2d"], np.float32)[keep]
            lab = np.asarray(res["labels"], np.int64)[keep]
            b3d = np.asarray(res["bboxes_3d"], np.float32)[keep].copy()
            b3d[:, 3:6] -= ann["cam_t_vec"]     # back to reference frame

            order = np.argsort(-b3d[:, 7])
            b2d, lab, b3d = b2d[order], lab[order], b3d[order]
            loc = b3d[:, 3:6]
            ry = b3d[:, 6]
            alpha = ry - np.arctan2(loc[:, 0], loc[:, 2] + 0.27)
            det_annos.append(
                dict(
                    name=np.asarray([self.classes[i] for i in lab]),
                    truncated=np.full(len(lab), -1, np.int8),
                    occluded=np.full(len(lab), -1, np.int8),
                    alpha=alpha,
                    bbox=b2d,
                    dimensions=b3d[:, :3],      # lhw
                    location=loc,
                    rotation_y=ry,
                    score=b3d[:, 7],
                )
            )
        return det_annos

    def format_gt_annos(self) -> List[Dict[str, np.ndarray]]:
        gt_annos = []
        for idx in range(len(self)):
            ann = self.get_ann(idx)
            n_obj = len(ann["bboxes"])
            n_dc = len(ann["bboxes_ignore"])
            gt_annos.append(
                dict(
                    name=[self.classes[i] for i in ann["labels"]]
                    + ["DontCare"] * n_dc,
                    truncated=np.concatenate(
                        [ann["truncation"], np.full(n_dc, -1.0)]
                    ),
                    occluded=np.concatenate(
                        [ann["occlusion"], np.full(n_dc, -1.0)]
                    ),
                    alpha=np.concatenate(
                        [ann["alpha"], np.full(n_dc, -10.0)]
                    ),
                    bbox=np.concatenate(
                        [ann["bboxes"], ann["bboxes_ignore"]], axis=0
                    ),
                    dimensions=np.concatenate(
                        [ann["bboxes_3d_eval"][:, :3],
                         np.full((n_dc, 3), -1.0, np.float32)], axis=0
                    ),
                    location=np.concatenate(
                        [ann["bboxes_3d_eval"][:, 3:6],
                         np.full((n_dc, 3), -1000.0, np.float32)], axis=0
                    ),
                    rotation_y=np.concatenate(
                        [ann["bboxes_3d_eval"][:, 6],
                         np.full(n_dc, -10.0, np.float32)], axis=0
                    ),
                    score=np.zeros(n_obj + n_dc, np.float32),
                )
            )
        return gt_annos

    def evaluate(
        self,
        results: List[Dict[str, np.ndarray]],
        metrics=("bbox", "bev", "3d"),
        criteria: str = "R40",
        result_dir: Optional[str] = None,
        print_summary: bool = True,
    ):
        from ..eval.kitti_eval import kitti_eval

        det_annos = self.format_results(results)
        if result_dir is not None:
            self.write_result_files(det_annos, result_dir)
        if not self.with_labels:
            return {}
        gt_annos = self.format_gt_annos()
        summary, ap_dict = kitti_eval(
            gt_annos, det_annos, self.classes, eval_types=list(metrics),
            criteria=criteria,
        )
        if print_summary:
            print("\n" + summary)
        return ap_dict

    def write_result_files(self, det_annos, result_dir: str):
        os.makedirs(result_dir, exist_ok=True)
        for anno, name in zip(det_annos, self.ids):
            lines = []
            for i in range(len(anno["name"])):
                d = anno["dimensions"][i]   # lhw -> hwl for the file
                lines.append(
                    f"{anno['name'][i]} {anno['truncated'][i]} "
                    f"{anno['occluded'][i]} {anno['alpha'][i]:.6f} "
                    + " ".join(f"{v:.6f}" for v in anno["bbox"][i])
                    + f" {d[1]:.6f} {d[2]:.6f} {d[0]:.6f} "
                    + " ".join(f"{v:.6f}" for v in anno["location"][i])
                    + f" {anno['rotation_y'][i]:.6f} {anno['score'][i]:.6f}"
                )
            with open(osp.join(result_dir, name + ".txt"), "w") as f:
                f.write("\n".join(lines) + ("\n" if lines else ""))


def prepare_meta_files(root: str, list_file: str, out_prefix="img_metas"):
    """tools/prepare_kitti.py equivalent: cache (h, w) per image."""
    import cv2

    out_dir = osp.join(root, out_prefix)
    os.makedirs(out_dir, exist_ok=True)
    with open(osp.join(root, list_file)) as f:
        ids = [ln.strip() for ln in f if ln.strip()]
    for name in ids:
        img = cv2.imread(osp.join(root, "image_2", name + ".png"))
        with open(osp.join(out_dir, name + ".txt"), "w") as f:
            f.write(f"{img.shape[0]},{img.shape[1]}")
    return len(ids)
