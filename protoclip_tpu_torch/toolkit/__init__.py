"""Deployment toolkit of the port (counterpart of ``protoclip_tpu/toolkit``;
the reference's ``proto-clip-toolkit`` package): the inference classifier,
OOD evaluation, t-SNE plots, robot-perception geometry, and the optional
speech and ROS layer.  The heavy and optional dependencies (sklearn,
matplotlib, cv2, flair, whisper, rospy) are imported inside the functions
that use them."""

from protoclip_tpu_torch.toolkit.classifier import ProtoClipClassifier
from protoclip_tpu_torch.toolkit.ood import test_ood_performance

__all__ = ["ProtoClipClassifier", "test_ood_performance"]
