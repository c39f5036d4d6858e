"""ROS node wrappers for the robot grasping demo (import-gated on rospy),
over the port's classifier (counterpart of ``protoclip_tpu/toolkit/
ros_nodes.py``).

Equivalents of the reference's ``proto_clip_node.py`` (speech-selected grasp
target: segmentation crops -> Proto-CLIP classify -> ASR+POS noun -> publish
selected mask) and ``proto_clip_results_node.py`` (periodic annotated
prediction canvas).  All perception math lives in ROS-free modules
(:mod:`protoclip_tpu_torch.toolkit.robot`, :mod:`...classifier`, :mod:`...speech`);
these classes only wire topics.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from protoclip_tpu_torch.toolkit.classifier import ProtoClipClassifier
from protoclip_tpu_torch.toolkit.robot import (
    backproject,
    crop_object_images,
    mask_bbox_3d,
    select_spoken_target,
)


def _require_ros():
    try:
        import rospy  # noqa: F401
    except ImportError as exc:  # pragma: no cover - ROS not in CI images
        raise ImportError(
            "ROS nodes require a ROS environment (rospy); the perception math "
            "is available without ROS in protoclip_tpu_torch.toolkit.robot"
        ) from exc


class SegImageListener:
    """Synchronized RGB-D + segmentation subscriber
    (ref ``seg_image_listener.py:34-197``): keeps the latest synchronized
    (rgb, depth, label, score) under a lock and exposes 3-D boxes per mask."""

    def __init__(self, camera: str = "Fetch"):  # pragma: no cover - needs ROS
        _require_ros()
        import rospy
        import message_filters
        from sensor_msgs.msg import CameraInfo, Image as RosImage

        self.lock = threading.Lock()
        self.rgb = self.depth = self.label = self.score = None
        self.intrinsics = None

        if camera == "Fetch":
            rgb_topic = "/head_camera/rgb/image_raw"
            depth_topic = "/head_camera/depth_registered/image_raw"
            info_topic = "/head_camera/rgb/camera_info"
        else:
            rgb_topic = "/camera/color/image_raw"
            depth_topic = "/camera/aligned_depth_to_color/image_raw"
            info_topic = "/camera/color/camera_info"

        info = rospy.wait_for_message(info_topic, CameraInfo)
        self.intrinsics = np.asarray(info.K, np.float32).reshape(3, 3)

        subs = [
            message_filters.Subscriber(rgb_topic, RosImage, queue_size=10),
            message_filters.Subscriber(depth_topic, RosImage, queue_size=10),
            message_filters.Subscriber("/seg_label_refined", RosImage, queue_size=10),
            message_filters.Subscriber("/seg_score", RosImage, queue_size=10),
        ]
        sync = message_filters.ApproximateTimeSynchronizer(subs, queue_size=10, slop=0.5)
        sync.registerCallback(self._callback)

    def _callback(self, rgb, depth, label, score):  # pragma: no cover
        from cv_bridge import CvBridge

        bridge = CvBridge()
        depth_cv = bridge.imgmsg_to_cv2(depth)
        # 16UC1 cameras (Fetch/RealSense depth_registered) publish
        # millimeters; store meters like the reference
        # (seg_image_listener.py:209-211)
        if depth.encoding == "16UC1":
            depth_cv = depth_cv.astype(np.float32) / 1000.0
        elif depth.encoding != "32FC1":
            # log-and-skip like the reference (seg_image_listener.py:216):
            # raising here would spam a traceback at frame rate and leave
            # the node permanently frameless
            import rospy

            rospy.logerr_throttle(
                1.0, f"unsupported depth encoding {depth.encoding!r}; skipping frame"
            )
            return
        with self.lock:
            self.rgb = bridge.imgmsg_to_cv2(rgb, "rgb8")
            self.depth = depth_cv
            self.label = bridge.imgmsg_to_cv2(label)
            self.score = bridge.imgmsg_to_cv2(score)

    def snapshot(self):
        with self.lock:
            return self.rgb, self.depth, self.label, self.score

    def save_data(self, save_dir: str, step: int, camera_pose=None) -> str:
        """Dump the latest frame in the reference's training-data layout
        (ref ``seg_image_listener.py:299-322``)."""
        from protoclip_tpu_torch.toolkit.robot import save_frame_data

        rgb, depth, label, score = self.snapshot()
        if rgb is None:
            raise RuntimeError("no synchronized frame received yet")
        return save_frame_data(
            save_dir, step, rgb, depth, label, score, self.intrinsics,
            np.eye(4) if camera_pose is None else camera_pose,
        )

    def object_boxes(self):
        rgb, depth, label, _ = self.snapshot()
        if rgb is None:
            return []
        xyz = backproject(depth, self.intrinsics)
        boxes = []
        for mask_id in np.unique(label):
            if mask_id == 0:
                continue
            box = mask_bbox_3d(xyz, label == mask_id)
            if box is not None:
                boxes.append((int(mask_id), box))
        return boxes

    def bbox_frame(self, camera_pose=None):
        """The reference's exact per-frame (num, 8) box array
        (``seg_image_listener.py:229-285``): base-frame point-mean centers,
        extents with 5%-trimmed z, mean score, mask id — zero-z rows
        filtered.  ``object_boxes`` above is this framework's own variant."""
        from protoclip_tpu_torch.toolkit.robot import segmentation_boxes_3d

        rgb, depth, label, score = self.snapshot()
        if rgb is None:
            return np.zeros((0, 8), np.float32)
        xyz = backproject(depth, self.intrinsics)
        return segmentation_boxes_3d(
            xyz, label, score, depth,
            np.eye(4) if camera_pose is None else camera_pose,
        )


class ProtoClipGraspNode:
    """Speech-selected grasp target publisher
    (ref ``proto_clip_node.py:31-121``)."""

    def __init__(
        self,
        classifier: ProtoClipClassifier,
        tagger=None,
        camera: str = "Fetch",
        republish_count: int = 10,
        asr_kwargs: Optional[dict] = None,
        log_dir: str = "./ros-demo-logs",
    ):  # pragma: no cover - needs ROS
        _require_ros()
        import rospy
        from std_msgs.msg import Int32, Float32

        self.classifier = classifier
        self.tagger = tagger
        self.listener = SegImageListener(camera)
        self.republish_count = republish_count
        # prediction-dump dir (ref proto_clip_classifier.py:151-156 logs
        # relative to the node's CWD; configurable here so embedders/tests
        # do not scatter .npy files into whatever directory ran them)
        self.log_dir = log_dir
        # transcribe_stream knobs from asr_config.json — the reference node
        # reads them via --asr_config_path (run_proto_clip_node.sh)
        self.asr_kwargs = dict(asr_kwargs or {})
        self.label_pub = rospy.Publisher("/selected_seg_label", Int32, queue_size=10)
        self.score_pub = rospy.Publisher("/selected_seg_score", Float32, queue_size=10)

    def run_once(self) -> Optional[str]:  # pragma: no cover - needs ROS + mic
        from protoclip_tpu_torch.toolkit.speech import transcribe_with_verb_and_noun_matching

        rgb, _, label, score = self.listener.snapshot()
        if rgb is None:
            return None
        crops, mask_ids = crop_object_images(label, rgb)
        names, probs = self.classifier.classify_objects(
            crops, log=True, rgb_image=rgb, log_dir=self.log_dir
        )
        _, noun = transcribe_with_verb_and_noun_matching(
            self.tagger, **self.asr_kwargs
        )
        if noun is None:
            return None
        # the reference picks the crop with the HIGHEST matching prob
        # across all crops, not the first match (proto_clip_node.py:79-92)
        target = select_spoken_target(names, probs, noun)
        if target is None:
            return None
        obj_idx, prob = target
        for _ in range(self.republish_count):
            self.label_pub.publish(mask_ids[obj_idx])
            self.score_pub.publish(prob)
            time.sleep(0.1)
        return noun


class ProtoClipResultsNode:
    """Periodic annotated-prediction publisher
    (ref ``proto_clip_results_node.py:25-73``)."""

    def __init__(
        self, classifier: ProtoClipClassifier, camera: str = "Fetch", period_s: float = 5.0
    ):  # pragma: no cover - needs ROS
        _require_ros()
        import rospy
        from sensor_msgs.msg import Image as RosImage

        self.classifier = classifier
        self.listener = SegImageListener(camera)
        self.period_s = period_s
        self.pub = rospy.Publisher("/proto_clip_pred", RosImage, queue_size=10)

    def spin(self):  # pragma: no cover - needs ROS
        import rospy
        from cv_bridge import CvBridge

        bridge = CvBridge()
        while not rospy.is_shutdown():
            rgb, _, label, _ = self.listener.snapshot()
            if rgb is not None:
                crops, _ = crop_object_images(label, rgb)
                if crops:
                    names, probs = self.classifier.classify_objects(crops, log=False)
                    canvas, _ = self.classifier.draw_image_with_top_k_images(
                        crops, names, probs
                    )
                    self.pub.publish(bridge.cv2_to_imgmsg(np.asarray(canvas), "rgb8"))
            time.sleep(self.period_s)
