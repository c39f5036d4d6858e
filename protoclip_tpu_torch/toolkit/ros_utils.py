"""ROS marker/grasp publisher utilities (a copy of ``protoclip_tpu/toolkit/
ros_utils.py``; ref ``toolkit/proto_clip_toolkit/
ros/utils/ros_utils.py:10-228``).

Quaternion-order converters, pose<->transform helpers, the legacy 8-color
segmentation palette, and the gripper-marker/grasp publishers used by the
grasping stack.  Everything that touches ROS message types or rospy is
import-gated; the math is plain numpy and unit-testable without ROS.

Quaternion conventions (as in the reference): ROS order is ``(x, y, z, w)``,
"standard" order is ``(w, x, y, z)``.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np

from protoclip_tpu_torch.toolkit.robot import (
    pose_to_transform,
    rotation_to_quaternion,
)

# -- quaternion order converters (ref ros_utils.py:10-30) --------------------


def convert_rosqt_to_standard(pose_ros: Sequence[float]) -> List[float]:
    """(x, y, z, qx, qy, qz, qw) -> (x, y, z, qw, qx, qy, qz)."""
    posn = list(pose_ros[:3])
    qx, qy, qz, qw = pose_ros[3:]
    return [*posn, qw, qx, qy, qz]


def convert_standard_to_rosqt(pose_s: Sequence[float]) -> List[float]:
    """(x, y, z, qw, qx, qy, qz) -> (x, y, z, qx, qy, qz, qw)."""
    posn = list(pose_s[:3])
    qw, qx, qy, qz = pose_s[3:]
    return [*posn, qx, qy, qz, qw]


def ros_quat(tf_quat: Sequence[float]) -> np.ndarray:
    """wxyz -> xyzw (ref ros_utils.py:26-30)."""
    quat = np.zeros(4)
    quat[-1] = tf_quat[0]
    quat[:-1] = tf_quat[1:]
    return quat


# -- pose <-> homogeneous transform (ref ros_utils.py:33-84) -----------------


def ros_qt_to_rt(rot: Sequence[float], trans: Sequence[float]) -> np.ndarray:
    """ROS (x, y, z, w) quaternion + translation -> 4x4 transform."""
    return pose_to_transform(trans, rot)


def rt_to_ros_qt(rt: np.ndarray):
    """4x4 transform -> (ROS xyzw quaternion, translation)."""
    rt = np.asarray(rt)
    quat = rotation_to_quaternion(rt[:3, :3]).tolist()
    trans = rt[:3, 3].tolist()
    return quat, trans


def ros_pose_to_rt(pose) -> np.ndarray:
    """geometry_msgs Pose -> 4x4 transform."""
    q = [pose.orientation.x, pose.orientation.y, pose.orientation.z, pose.orientation.w]
    t = [pose.position.x, pose.position.y, pose.position.z]
    return ros_qt_to_rt(q, t)


def rt_to_ros_pose(pose, rt: np.ndarray):
    """Fill a geometry_msgs Pose in-place from a 4x4 transform."""
    quat, trans = rt_to_ros_qt(rt)
    pose.orientation.x, pose.orientation.y, pose.orientation.z, pose.orientation.w = quat
    pose.position.x, pose.position.y, pose.position.z = trans
    return pose


def inverse_transform(trans: np.ndarray) -> np.ndarray:
    """Inverse of a rigid 4x4 transform (ref ros_utils.py:115-124)."""
    trans = np.asarray(trans)
    rot = trans[:3, :3].T
    t = -rot @ trans[:3, 3]
    output = np.zeros((4, 4), dtype=np.float32)
    output[3, 3] = 1.0
    output[:3, :3] = rot
    output[:3, 3] = t
    return output


def get_relative_pose_from_tf(listener, source_frame: str, target_frame: str) -> np.ndarray:
    """Poll a tf listener for up to 3 s (ref ros_utils.py:127-144); falls back
    to identity if the transform never arrives."""
    init_trans, init_rot = np.array([0.0, 0.0, 0.0]), np.array([0.0, 0.0, 0.0, 1.0])
    first = True
    time_start = time.time()
    while time.time() - time_start < 3:
        try:
            init_trans, init_rot = listener.lookupTransform(
                target_frame, source_frame, __import__("rospy").Time(0)
            )
            break
        except Exception as exc:  # pragma: no cover - tf timing
            if first:
                print(str(exc))
                first = False
            continue
    return ros_qt_to_rt(init_rot, init_trans)


# -- legacy 8-color seg palette (ref ros_utils.py:147-172) -------------------

PALETTE = [
    [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, 0, 1],
    [0.5, 0.5, 0], [1, 1, 1], [1, 1, 1], [0, 1, 1],
]


def map_seg_image(image: np.ndarray) -> np.ndarray:
    """Label image -> BGR uint8 visualization with the legacy palette
    (label i+1 takes PALETTE[i]; note the reference's channel reversal)."""
    image = np.squeeze(np.asarray(image))
    out = np.zeros((image.shape[0], image.shape[1], 3), np.uint8)
    for i, color in enumerate(PALETTE):
        mask = image == (i + 1)
        for j in range(3):
            out[..., j][mask] = int(color[2 - j] * 255)
    return out


# -- marker / grasp publishers (rospy-gated; ref ros_utils.py:175-228) -------


def create_gripper_marker_message(
    frame_id: str,
    namespace: str,
    mesh_resource: str,
    color: Sequence[float],
    lifetime: bool = True,
    mesh_use_embedded_materials: bool = True,
    marker_id: int = 0,
    frame_locked: bool = False,
):  # pragma: no cover - needs ROS message types
    import rospy
    from visualization_msgs.msg import Marker

    marker = Marker()
    marker.action = Marker.ADD
    marker.id = marker_id
    marker.ns = namespace
    if lifetime:
        marker.lifetime = rospy.Duration(0.2)
    marker.frame_locked = frame_locked
    marker.header.frame_id = frame_id
    marker.header.stamp = rospy.Time.now()
    marker.scale.x = marker.scale.y = marker.scale.z = 1.0
    marker.color.r, marker.color.g, marker.color.b, marker.color.a = color
    marker.type = Marker.MESH_RESOURCE
    marker.mesh_resource = mesh_resource
    marker.mesh_use_embedded_materials = mesh_use_embedded_materials
    return marker


def grasp_marker_colors(
    n_grasps: int, scores: Optional[float] = None, color_alpha: float = 1.0
) -> List[List[float]]:
    """Red->green ramp over grasp index, or a single score-derived color for
    all markers (the reference's scalar-``scores`` behavior,
    ros_utils.py:205-211).  ROS-free so the ramp is unit-testable."""
    colors = []
    for i in range(n_grasps):
        x = (float(i) / n_grasps) if scores is None else float(scores)
        colors.append([1.0 - x, x, 0.0, color_alpha])
    return colors


def publish_grasps(
    publisher, frame_id: str, grasps: Sequence[np.ndarray], color_alpha: float,
    scores: Optional[float] = None,
    mesh_resource: str = "package://grasping_vae/panda_gripper.obj",
):  # pragma: no cover - needs ROS
    """Publish a MarkerArray of gripper meshes at the grasp poses
    (4x4 transforms), colored red->green by rank (ref ros_utils.py:204-228).

    Deliberate fix vs the reference: it feeds ``mat2quat``'s (w, x, y, z)
    output positionally into ``Quaternion(x, y, z, w)`` (ros_utils.py:221),
    publishing component-shifted orientations; here ``rt_to_ros_qt`` emits
    proper ROS xyzw order."""
    from geometry_msgs.msg import Point, Pose, Quaternion
    from visualization_msgs.msg import MarkerArray

    markers = MarkerArray()
    colors = grasp_marker_colors(len(grasps), scores, color_alpha)
    for i, (g, color) in enumerate(zip(grasps, colors)):
        marker = create_gripper_marker_message(
            frame_id=frame_id,
            namespace="hand",
            mesh_resource=mesh_resource,
            color=color,
            marker_id=i,
        )
        quat, pos = rt_to_ros_qt(np.asarray(g))
        marker.pose = Pose(position=Point(*pos), orientation=Quaternion(*quat))
        markers.markers.append(marker)
    publisher.publish(markers)
