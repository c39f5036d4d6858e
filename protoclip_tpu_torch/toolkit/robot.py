"""Robot-perception geometry and segmentation utilities (ROS-free core; a
copy of ``protoclip_tpu/toolkit/robot.py``).

The reference splits these across ``toolkit/.../ros/utils/{image_utils,
seg_image_listener,ros_utils,segmentation_utils}.py``; everything here is
pure numpy and testable without a robot.  The thin rospy node wrappers live
in :mod:`protoclip_tpu_torch.toolkit.ros_nodes` (import-gated on rospy).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# -- segmentation crops -----------------------------------------------------


def crop_object_images(
    label: np.ndarray, rgb_image: np.ndarray, min_size: int = 5
) -> Tuple[List[np.ndarray], List[int]]:
    """Crop per-mask object images from a segmentation label map
    (ref ``image_utils.py:27-61``): background id 0 skipped, tiny masks
    (<= min_size pixels in either dimension) rejected."""
    mask_ids = np.unique(label)
    if len(mask_ids) and mask_ids[0] == 0:
        mask_ids = mask_ids[1:]

    crops: List[np.ndarray] = []
    kept_ids: List[int] = []
    for mask_id in mask_ids:
        ys, xs = np.nonzero(label == mask_id)
        if len(ys) == 0:
            continue
        y_min, y_max = ys.min(), ys.max()
        x_min, x_max = xs.min(), xs.max()
        if (x_max - x_min <= min_size) or (y_max - y_min <= min_size):
            continue
        crops.append(rgb_image[y_min:y_max, x_min:x_max, :])
        kept_ids.append(int(mask_id))
    return crops, kept_ids


# -- 3-D geometry -----------------------------------------------------------


def backproject(depth: np.ndarray, intrinsics: np.ndarray) -> np.ndarray:
    """Depth map (H, W) -> XYZ point image (H, W, 3) via pinhole intrinsics
    (ref ``ros_utils.py`` backprojection / ``seg_image_listener.py:25-31``)."""
    h, w = depth.shape
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    xs = np.arange(w, dtype=np.float32)
    ys = np.arange(h, dtype=np.float32)
    grid_x, grid_y = np.meshgrid(xs, ys)
    z = depth.astype(np.float32)
    x = (grid_x - cx) * z / fx
    y = (grid_y - cy) * z / fy
    return np.stack([x, y, z], axis=-1)


def mask_bbox_3d(
    xyz_image: np.ndarray,
    mask: np.ndarray,
    z_outlier_sigma: float = 2.0,
) -> Optional[Dict[str, np.ndarray]]:
    """Axis-aligned 3-D bounding box of a mask's points with z-outlier
    trimming (ref ``seg_image_listener.py:229-285``).

    Points whose z deviates more than ``z_outlier_sigma`` standard deviations
    from the mask's median z are discarded before the box is fit; returns
    ``{"center", "extent", "points"}`` or None if the mask is empty.
    """
    points = xyz_image[mask > 0]
    points = points[points[:, 2] > 0]  # invalid depth
    if len(points) == 0:
        return None
    z = points[:, 2]
    med = np.median(z)
    std = z.std() or 1e-6
    keep = np.abs(z - med) <= z_outlier_sigma * std
    points = points[keep]
    if len(points) == 0:
        return None
    mins, maxs = points.min(axis=0), points.max(axis=0)
    return {
        "center": (mins + maxs) / 2.0,
        "extent": maxs - mins,
        "points": points,
    }


def erode3x3(mask: np.ndarray) -> np.ndarray:
    """Binary 3x3 erosion, ``cv2.erode(mask, np.ones((3, 3)))`` semantics:
    a pixel survives only if its full 8-neighborhood is set, with
    out-of-image neighbors IGNORED (cv2's default morphology border value
    is +inf, which a min-filter discards) — so edge pixels erode against
    their in-image neighbors only."""
    m = np.asarray(mask).astype(bool)
    padded = np.pad(m, 1, constant_values=True)  # border ignored = True
    out = np.ones_like(m)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out &= padded[1 + dy : 1 + dy + m.shape[0], 1 + dx : 1 + dx + m.shape[1]]
    return out


def segmentation_boxes_3d(
    xyz_image: np.ndarray,
    label: np.ndarray,
    score: np.ndarray,
    depth: np.ndarray,
    camera_pose: np.ndarray,
) -> np.ndarray:
    """Per-mask 3-D boxes in the robot base frame, the reference's exact
    per-frame computation (ref ``seg_image_listener.py:229-285``): each
    mask is 3x3-eroded, intersected with valid depth, its points moved to
    the base frame by ``camera_pose``, and summarized as a row
    ``[center_xyz (point MEAN, not box center), x_extent, y_extent,
    z_extent (5%-percentile-trimmed against depth noise), mean score,
    mask_id]`` — ``(num, 8) float32``, rows with zero z extent filtered
    out, exactly like the reference (so a fully-eroded or depthless mask
    disappears rather than yielding a degenerate box).

    ``mask_bbox_3d`` above is this framework's own variant (box-center +
    sigma-based trimming); THIS function is the reference-parity path the
    ROS listener exposes (the JAX package's copy is diffed against the
    executed reference in ``tests/test_reference_toolkit_diff.py``)."""
    label = np.asarray(label)
    mask_ids = np.unique(label)
    if len(mask_ids) and mask_ids[0] == 0:
        mask_ids = mask_ids[1:]
    camera_pose = np.asarray(camera_pose, np.float64)
    rows = np.zeros((len(mask_ids), 8), dtype=np.float32)
    for index, mask_id in enumerate(mask_ids):
        mask = erode3x3(label == mask_id) & (np.asarray(depth) > 0)
        points = xyz_image[mask, :]
        confidence = np.mean(np.asarray(score)[mask]) if mask.any() else np.nan
        points_base = (camera_pose[:3, :3] @ points.T).T + camera_pose[:3, 3]
        center = np.mean(points_base, axis=0) if len(points_base) else np.full(3, np.nan)
        if points_base.shape[0] > 0:
            x = np.max(points_base[:, 0]) - np.min(points_base[:, 0])
            y = np.max(points_base[:, 1]) - np.min(points_base[:, 1])
            z_sorted = np.sort(points_base[:, 2])
            n = len(z_sorted)
            lower, upper = int(n * 0.05), int(n * 0.95)
            z_sel = z_sorted[lower:upper] if upper > lower else z_sorted
            z = np.max(z_sel) - np.min(z_sel)
        else:
            x = y = z = 0.0
        rows[index, :3] = center
        rows[index, 3:7] = (x, y, z, confidence)
        rows[index, 7] = mask_id
    return rows[rows[:, 5] > 0, :]


def select_spoken_target(
    top_k_classes: Sequence[Sequence[str]],
    top_k_probs,
    spoken_noun: str,
) -> Optional[Tuple[int, float]]:
    """Pick the crop to grasp for a spoken object name — the reference's
    exact rule (ref ``proto_clip_node.py:79-92``): among all crops whose
    top-k predictions contain ``spoken_noun``, choose the one with the
    HIGHEST probability at the noun's (first) position; ``None`` when no
    prediction contains it.  Returns ``(crop index, matching prob)``."""
    chosen_idx, chosen_prob = None, float("-inf")
    for img_idx, row in enumerate(top_k_classes):
        if spoken_noun not in row:
            continue
        prob = float(top_k_probs[img_idx][list(row).index(spoken_noun)])
        if prob > chosen_prob:
            chosen_idx, chosen_prob = img_idx, prob
    if chosen_idx is None:
        return None
    return chosen_idx, chosen_prob


def quaternion_to_rotation(q: Sequence[float]) -> np.ndarray:
    """Unit quaternion (x, y, z, w) -> 3x3 rotation matrix
    (ref ``ros_utils.py`` quaternion helpers)."""
    x, y, z, w = q
    n = x * x + y * y + z * z + w * w
    if n < 1e-12:
        return np.eye(3)
    s = 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.asarray(
        [
            [1.0 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1.0 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1.0 - (xx + yy)],
        ],
        np.float32,
    )


def rotation_to_quaternion(R: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix -> unit quaternion (x, y, z, w)."""
    R = np.asarray(R, np.float64)
    trace = np.trace(R)
    if trace > 0:
        s = 0.5 / np.sqrt(trace + 1.0)
        w = 0.25 / s
        x = (R[2, 1] - R[1, 2]) * s
        y = (R[0, 2] - R[2, 0]) * s
        z = (R[1, 0] - R[0, 1]) * s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12))
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[3] = (R[k, j] - R[j, k]) / s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        x, y, z, w = q
    out = np.asarray([x, y, z, w], np.float64)
    return (out / np.linalg.norm(out)).astype(np.float32)


def pose_to_transform(translation: Sequence[float], quaternion: Sequence[float]) -> np.ndarray:
    """(t, q) -> homogeneous 4x4 transform."""
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = quaternion_to_rotation(quaternion)
    T[:3, 3] = np.asarray(translation, np.float32)
    return T


# -- segmentation visualization ---------------------------------------------

_SEG_PALETTE = np.asarray(
    [
        (0, 0, 0),
        (230, 25, 75), (60, 180, 75), (255, 225, 25), (0, 130, 200),
        (245, 130, 48), (145, 30, 180), (70, 240, 240), (240, 50, 230),
        (210, 245, 60), (250, 190, 190), (0, 128, 128), (230, 190, 255),
        (170, 110, 40), (255, 250, 200), (128, 0, 0), (170, 255, 195),
        (128, 128, 0), (255, 215, 180), (0, 0, 128), (128, 128, 128),
    ],
    np.uint8,
)


def seg_color_map(n: int) -> np.ndarray:
    """n distinct RGB colors (cycled palette; ref ``ros_utils.py`` colormap)."""
    reps = -(-n // (len(_SEG_PALETTE) - 1))
    return np.tile(_SEG_PALETTE[1:], (reps, 1))[:n]


def visualize_segmentation(
    rgb: np.ndarray, label: np.ndarray, alpha: float = 0.5
) -> np.ndarray:
    """Blend colored masks over the RGB image and outline mask borders
    (ref ``segmentation_utils.py:7-111``)."""
    out = rgb.astype(np.float32).copy()
    mask_ids = [m for m in np.unique(label) if m != 0]
    colors = seg_color_map(max(len(mask_ids), 1))
    for idx, mask_id in enumerate(mask_ids):
        mask = label == mask_id
        out[mask] = (1 - alpha) * out[mask] + alpha * colors[idx]
        # 1-pixel border: mask minus its erosion
        border = mask & ~_erode(mask)
        out[border] = colors[idx]
    return np.clip(out, 0, 255).astype(np.uint8)


def _erode(mask: np.ndarray) -> np.ndarray:
    e = mask.copy()
    e[1:] &= mask[:-1]
    e[:-1] &= mask[1:]
    e[:, 1:] &= mask[:, :-1]
    e[:, :-1] &= mask[:, 1:]
    return e


def visualize_segmentation_reference(
    im: np.ndarray, masks: np.ndarray, nc: Optional[int] = None
) -> np.ndarray:
    """Pixel-exact port of the reference's programmatic
    (``return_rgb=True``) visualization (ref ``segmentation_utils.py:7-111``,
    itself derived from Detectron's vis.py): gist_rainbow colors indexed BY
    MASK ID (not enumeration order — ids above ``nc`` would IndexError
    there too, so the same bound is enforced), whitened by a 0.4 ratio,
    alpha-0.5 ``addWeighted`` blend, then white 2-px cv2 contours.  Needs
    cv2 + matplotlib (import-gated); ``visualize_segmentation`` above is
    this framework's dependency-light variant."""
    import cv2
    from matplotlib import pyplot as plt

    masks = np.asarray(masks).astype(int)
    im = np.asarray(im).copy()
    n_colors = int(masks.max()) + 1 if nc is None else int(nc)
    cm = plt.get_cmap("gist_rainbow")
    colors = [cm(1.0 * i / n_colors) for i in range(n_colors)]

    def whitened(mask_id):
        c = np.array(colors[mask_id][:3])
        return c * (1 - 0.4) + 0.4

    img_mask = np.zeros(im.shape)
    for i in np.unique(masks):
        if i == 0:
            continue
        img_mask[masks == i] = whitened(i)
    img_mask = (img_mask * 255).round().astype(np.uint8)
    im = cv2.addWeighted(im, 0.5, img_mask, 0.5, 0.0)

    for i in np.unique(masks):
        if i == 0:
            continue
        contours, _ = cv2.findContours(
            (masks == i).astype(np.uint8).copy(),
            cv2.RETR_CCOMP,
            cv2.CHAIN_APPROX_NONE,
        )
        cv2.drawContours(im, contours, -1, (255, 255, 255), 2)
    return im


def save_frame_data(
    save_dir: str,
    step: int,
    rgb: np.ndarray,
    depth: np.ndarray,
    label: np.ndarray,
    score: np.ndarray,
    intrinsics: np.ndarray,
    camera_pose: np.ndarray,
    factor_depth: float = 1000.0,
) -> str:
    """Dump one camera frame to disk in the reference's training-data layout
    (ref ``seg_image_listener.py:299-322``): ``meta-%06d.mat`` (intrinsics,
    depth factor, camera pose), ``color-%06d.jpg``, ``depth-%06d.png``
    (uint16, depth * factor), ``label-%06d.png``, ``gt-%06d.jpg``
    (segmentation overlay), ``score-%06d.png``.  Returns the meta path.
    ROS-free: callers pass plain arrays."""
    import os

    from PIL import Image

    from protoclip_tpu_torch.io.mat import save_mat

    os.makedirs(save_dir, exist_ok=True)
    meta_path = os.path.join(save_dir, f"meta-{step:06d}.mat")
    save_mat(
        meta_path,
        {
            "intrinsic_matrix": np.asarray(intrinsics, np.float64),
            "factor_depth": float(factor_depth),
            "camera_pose": np.asarray(camera_pose, np.float64),
        },
    )
    depth_u16 = np.asarray(np.asarray(depth, np.float64) * factor_depth, np.uint16)
    Image.fromarray(np.asarray(rgb, np.uint8)).save(
        os.path.join(save_dir, f"color-{step:06d}.jpg")
    )
    Image.fromarray(depth_u16).save(  # uint16 infers I;16
        os.path.join(save_dir, f"depth-{step:06d}.png")
    )
    Image.fromarray(np.asarray(label, np.uint8)).save(
        os.path.join(save_dir, f"label-{step:06d}.png")
    )
    Image.fromarray(visualize_segmentation(np.asarray(rgb), np.asarray(label))).save(
        os.path.join(save_dir, f"gt-{step:06d}.jpg")
    )
    Image.fromarray(np.asarray(score, np.uint8)).save(
        os.path.join(save_dir, f"score-{step:06d}.png")
    )
    return meta_path
