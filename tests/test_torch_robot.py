"""The port's framework-free robot, ROS-helper, speech and ASR-CLI functions
(``toolkit/robot.py``, ``toolkit/ros_utils.py``, ``toolkit/speech.py``,
``cli/transcribe.py``) against the JAX package's, on seeded inputs: each
case runs in both packages and must give equal outputs (arrays equal in
dtype, shape and bytes) or raise the same exception with the same message.
None of rospy, flair, whisper or SpeechRecognition is installed, so their
gates must raise alike too."""

import dataclasses
import json
import sys
import types

import numpy as np
import pytest
from PIL import Image

import protoclip_tpu.cli.transcribe as jax_transcribe
import protoclip_tpu.toolkit.robot as jax_robot
import protoclip_tpu.toolkit.ros_utils as jax_ros_utils
import protoclip_tpu.toolkit.speech as jax_speech

import protoclip_tpu_torch.cli.transcribe as transcribe
import protoclip_tpu_torch.toolkit.robot as robot
import protoclip_tpu_torch.toolkit.ros_utils as ros_utils
import protoclip_tpu_torch.toolkit.speech as speech

PORT = types.SimpleNamespace(robot=robot, ros_utils=ros_utils, speech=speech,
                             transcribe=transcribe)
JAX = types.SimpleNamespace(robot=jax_robot, ros_utils=jax_ros_utils, speech=jax_speech,
                            transcribe=jax_transcribe)


def _canonical(value):
    """A comparable form: arrays by dtype, shape and bytes, dataclasses and
    namespaces by their fields, images by their pixels."""
    if isinstance(value, Image.Image):
        value = np.asarray(value)
    if isinstance(value, np.ndarray):
        return ("ndarray", str(value.dtype), value.shape, value.tobytes())
    if isinstance(value, np.generic):
        return ("scalar", str(value.dtype), value.tobytes())
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return ("dataclass", _canonical(dataclasses.asdict(value)))
    if isinstance(value, types.SimpleNamespace):
        return ("namespace", _canonical(vars(value)))
    if isinstance(value, dict):
        return {k: _canonical(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return (type(value).__name__, [_canonical(v) for v in value])
    if isinstance(value, set):
        return ("set", sorted(value))
    return value


def _outcome(case, pkg, tmp_path):
    try:
        return ("returned", _canonical(case(pkg, tmp_path)))
    except (Exception, SystemExit) as exc:  # the exception is the outcome compared
        return ("raised", type(exc).__name__, str(exc))


def _frame(seed=0, h=48, w=64):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    depth = rng.uniform(0.5, 2.0, (h, w)).astype(np.float32)
    depth[:4, :4] = 0.0  # invalid depth
    label = np.zeros((h, w), np.int32)
    label[4:20, 5:30] = 1
    label[25:40, 30:60] = 3
    label[42:45, 2:5] = 7  # below min_size, and erodes away
    score = rng.uniform(0, 1, (h, w)).astype(np.float32)
    K = np.asarray([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]])
    return rgb, depth, label, score, K


def _quaternion(seed):
    q = np.random.default_rng(seed).standard_normal(4)
    return q / np.linalg.norm(q)


def _pose(seed):
    """A seeded 4x4 rigid transform (the same input for both packages)."""
    return robot.pose_to_transform(np.random.default_rng(seed).standard_normal(3),
                                   _quaternion(seed))


def _boxes(pkg, tmp):
    rgb, depth, label, score, K = _frame()
    xyz = pkg.robot.backproject(depth, K)
    return pkg.robot.segmentation_boxes_3d(xyz, label, score, depth, _pose(3))


def _tagged():
    return [("please", "UH"), ("pick", "VB"), ("up", "RP"), ("the", "DT"), ("mustard", "NN"),
            ("bottle", "NN"), ("and", "CC"), ("the", "DT"), ("mug", "NN"), ("now", "RB")]


def _write(tmp, name, text):
    path = tmp / name
    path.write_text(text)
    return str(path)


def _asr_config(tmp, data):
    return _write(tmp, "asr.json", json.dumps(data))


class _Listener:
    def lookupTransform(self, target, source, stamp):  # noqa: N802 (the tf API)
        return [0.1, -0.2, 0.3], list(_quaternion(5))


def _relative_pose(pkg, tmp):
    rospy = types.ModuleType("rospy")
    rospy.Time = lambda secs: secs
    saved = sys.modules.get("rospy")
    sys.modules["rospy"] = rospy
    try:
        return pkg.ros_utils.get_relative_pose_from_tf(_Listener(), "camera", "base")
    finally:
        if saved is None:
            del sys.modules["rospy"]
        else:
            sys.modules["rospy"] = saved


def _ros_pose(seed):
    q, t = _quaternion(seed), np.random.default_rng(seed).standard_normal(3)
    return types.SimpleNamespace(
        orientation=types.SimpleNamespace(x=q[0], y=q[1], z=q[2], w=q[3]),
        position=types.SimpleNamespace(x=t[0], y=t[1], z=t[2]))


def _empty_ros_pose():
    return types.SimpleNamespace(orientation=types.SimpleNamespace(),
                                 position=types.SimpleNamespace())


NAMES = [["mug", "red cup", "drill"], ["drill", "mug", "bowl"], ["bowl", "plate", "mug"],
         ["plate", "bowl", "fork"]]
PROBS = np.asarray([[0.5, 0.3, 0.2], [0.4, 0.35, 0.25], [0.6, 0.38, 0.02],
                    [0.7, 0.2, 0.1]], np.float32)

CASES = {
    # -- toolkit/robot.py
    "crop_object_images": lambda p, t: p.robot.crop_object_images(_frame()[2], _frame()[0]),
    "crop_object_images_min_size_0": lambda p, t: p.robot.crop_object_images(
        _frame()[2], _frame()[0], min_size=0),
    "crop_object_images_background_only": lambda p, t: p.robot.crop_object_images(
        np.zeros((8, 8), np.int32), np.zeros((8, 8, 3), np.uint8)),
    "backproject": lambda p, t: p.robot.backproject(_frame()[1], _frame()[4]),
    "mask_bbox_3d": lambda p, t: p.robot.mask_bbox_3d(
        p.robot.backproject(_frame()[1], _frame()[4]), _frame()[2] == 3, 1.5),
    "mask_bbox_3d_empty": lambda p, t: p.robot.mask_bbox_3d(
        np.zeros((4, 4, 3), np.float32), np.ones((4, 4))),
    "erode3x3": lambda p, t: p.robot.erode3x3(np.random.default_rng(1).random((12, 9)) > 0.3),
    "segmentation_boxes_3d": _boxes,
    "select_spoken_target": lambda p, t: p.robot.select_spoken_target(NAMES, PROBS, "mug"),
    "select_spoken_target_no_match": lambda p, t: p.robot.select_spoken_target(
        NAMES, PROBS, "spoon"),
    "quaternion_to_rotation": lambda p, t: p.robot.quaternion_to_rotation(_quaternion(0)),
    "quaternion_to_rotation_zero": lambda p, t: p.robot.quaternion_to_rotation([0, 0, 0, 0]),
    "rotation_to_quaternion": lambda p, t: p.robot.rotation_to_quaternion(
        p.robot.quaternion_to_rotation(_quaternion(1))),
    "rotation_to_quaternion_negative_trace": lambda p, t: p.robot.rotation_to_quaternion(
        np.diag([1.0, -1.0, -1.0])),
    "pose_to_transform": lambda p, t: p.robot.pose_to_transform([1, 2, 3], _quaternion(2)),
    "seg_color_map": lambda p, t: p.robot.seg_color_map(50),
    "visualize_segmentation": lambda p, t: p.robot.visualize_segmentation(
        _frame()[0], _frame()[2], 0.4),
    "visualize_segmentation_reference": lambda p, t: p.robot.visualize_segmentation_reference(
        _frame()[0], _frame()[2]),
    "visualize_segmentation_reference_nc_too_small": lambda p, t:
        p.robot.visualize_segmentation_reference(_frame()[0], _frame()[2], nc=3),
    # -- toolkit/ros_utils.py
    "convert_rosqt_to_standard": lambda p, t: p.ros_utils.convert_rosqt_to_standard(
        [0.1, 0.2, 0.3, 0.0, 0.707, 0.0, 0.707]),
    "convert_standard_to_rosqt": lambda p, t: p.ros_utils.convert_standard_to_rosqt(
        [0.1, 0.2, 0.3, 0.707, 0.0, 0.707, 0.0]),
    "ros_quat": lambda p, t: p.ros_utils.ros_quat([0.9, 0.1, 0.2, 0.3]),
    "ros_qt_to_rt": lambda p, t: p.ros_utils.ros_qt_to_rt(_quaternion(3), [1.0, -2.0, 0.5]),
    "rt_to_ros_qt": lambda p, t: p.ros_utils.rt_to_ros_qt(_pose(4)),
    "ros_pose_to_rt": lambda p, t: p.ros_utils.ros_pose_to_rt(_ros_pose(6)),
    "rt_to_ros_pose": lambda p, t: p.ros_utils.rt_to_ros_pose(_empty_ros_pose(), _pose(7)),
    "inverse_transform": lambda p, t: p.ros_utils.inverse_transform(_pose(8)),
    "get_relative_pose_from_tf": _relative_pose,
    "map_seg_image": lambda p, t: p.ros_utils.map_seg_image(
        np.random.default_rng(2).integers(0, 10, (1, 9, 11))),
    "grasp_marker_colors": lambda p, t: p.ros_utils.grasp_marker_colors(5),
    "grasp_marker_colors_scored": lambda p, t: p.ros_utils.grasp_marker_colors(3, 0.25, 0.5),
    "publish_grasps_without_ros": lambda p, t: p.ros_utils.publish_grasps(None, "base",
                                                                          [np.eye(4)], 1.0),
    "create_gripper_marker_message_without_ros": lambda p, t:
        p.ros_utils.create_gripper_marker_message("base", "hand", "mesh", (1, 0, 0, 1)),
    # -- toolkit/speech.py
    "merge_adjacent_same_tags": lambda p, t: p.speech.merge_adjacent_same_tags(_tagged()),
    "find_valid_noun_and_verb": lambda p, t: p.speech.find_valid_noun_and_verb(
        _tagged(), {"pick", "grasp"}, {"mustard bottle", "mug"}),
    "find_valid_noun_and_verb_none": lambda p, t: p.speech.find_valid_noun_and_verb(
        _tagged(), {"grasp"}, {"bowl"}),
    "load_dictionary": lambda p, t: p.speech.load_dictionary(
        _write(t, "nouns.txt", "mustard_bottle\n\npower_drill\n  mug  \n"), True),
    "noun_dictionary_from_splits": lambda p, t: p.speech.noun_dictionary_from_splits(_write(
        t, "s.json", json.dumps({"train": [["a", 0, "mustard_bottle"], ["b", 1, "mug"]]}))),
    "tagger_needs_one_noun_source": lambda p, t: p.speech.VerbAndNounTagger("verbs.txt"),
    "tagger_without_flair": lambda p, t: p.speech.VerbAndNounTagger("verbs.txt",
                                                                    noun_set={"mug"}),
    "list_microphones_without_pyaudio": lambda p, t: p.speech.list_microphones(),
    "transcribe_stream_without_whisper": lambda p, t: p.speech.transcribe_stream(
        lambda text: True),
    # -- cli/transcribe.py
    "load_asr_config": lambda p, t: p.transcribe.load_asr_config(_asr_config(t, {
        "model": "whisper-small", "non_english": True, "energy_threshold": 300,
        "record_timeout": 1.5, "phrase_timeout": 2, "default_microphone": "pulse"})),
    "load_asr_config_unknown_key": lambda p, t: p.transcribe.load_asr_config(
        _asr_config(t, {"model": "whisper-base", "sample_rate": 16000})),
    "load_asr_config_bad_type": lambda p, t: p.transcribe.load_asr_config(
        _asr_config(t, {"non_english": "false"})),
    "load_asr_config_bool_count": lambda p, t: p.transcribe.load_asr_config(
        _asr_config(t, {"record_timeout": True})),
    "load_asr_config_negative_threshold": lambda p, t: p.transcribe.load_asr_config(
        _asr_config(t, {"energy_threshold": -1})),
    "load_asr_config_not_an_object": lambda p, t: p.transcribe.load_asr_config(
        _asr_config(t, [1, 2])),
    "resolve_whisper_model": lambda p, t: [
        p.transcribe.resolve_whisper_model(m, ne)
        for m in ("whisper-tiny", "whisper-medium", "whisper-large-v3", "whisper-turbo")
        for ne in (False, True)],
    "resolve_whisper_model_invalid": lambda p, t: p.transcribe.resolve_whisper_model("whisper-"),
    "stream_kwargs": lambda p, t: p.transcribe.stream_kwargs(
        p.transcribe.AsrConfig(model="whisper-base", default_microphone="usb")),
    "parse_args_plain": lambda p, t: vars(p.transcribe.parse_args(["--config", "a.json"])),
    "parse_args_pos": lambda p, t: vars(p.transcribe.parse_args(
        ["--config", "a.json", "--mode", "pos", "--verb_dict", "v.txt", "--splits", "s.json"])),
    "parse_args_pos_without_verbs": lambda p, t: p.transcribe.parse_args(
        ["--config", "a.json", "--mode", "pos"]),
    "parse_args_pos_without_nouns": lambda p, t: p.transcribe.parse_args(
        ["--config", "a.json", "--mode", "pos", "--verb_dict", "v.txt"]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_framework_free_function_matches_jax(name, tmp_path):
    case = CASES[name]
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    ours = _outcome(case, PORT, tmp_path / "port")
    ref = _outcome(case, JAX, tmp_path / "jax")
    if ours[0] == "raised":  # paths in messages name each package's own directory
        ours = (*ours[:2], ours[2].replace(str(tmp_path / "port"), "TMP"))
        ref = (*ref[:2], ref[2].replace(str(tmp_path / "jax"), "TMP"))
    assert ours == ref


def test_select_spoken_target_takes_the_most_probable_match():
    """Several crops predict "mug"; the one with the highest probability at
    the noun's position wins (crop 1, 0.35), not the first match (crop 0)."""
    names = [["bowl", "mug"], ["mug", "bowl"], ["plate", "mug"]]
    probs = np.asarray([[0.7, 0.2], [0.35, 0.3], [0.5, 0.3]], np.float32)
    assert robot.select_spoken_target(names, probs, "mug") == (1, pytest.approx(0.35))
    assert robot.select_spoken_target(names, probs, "plate") == (2, pytest.approx(0.5))
    assert robot.select_spoken_target(names, probs, "spoon") is None
    assert robot.select_spoken_target([], np.zeros((0, 2)), "mug") is None


def test_save_frame_data_layout_matches_jax(tmp_path):
    """The reference's training-data layout: the same six files as the JAX
    package writes, images byte for byte, the ``.mat`` with equal variables
    in both packages' readers."""
    from protoclip_tpu.io.mat import load_mat as jax_load_mat

    from protoclip_tpu_torch.io.mat import load_mat, mat_scalar

    rgb, depth, label, score, K = _frame()
    score_u8 = (score * 255).astype(np.uint8)
    pose = _pose(9)
    written = {}
    for who, pkg in (("port", robot), ("jax", jax_robot)):
        out = tmp_path / who
        meta = pkg.save_frame_data(str(out), 12, rgb, depth, label, score_u8, K, pose)
        assert meta == str(out / "meta-000012.mat")
        written[who] = sorted(p.name for p in out.iterdir())
    assert written["port"] == written["jax"] == sorted(
        f"{kind}-000012.{ext}" for kind, ext in (("meta", "mat"), ("color", "jpg"),
                                                 ("depth", "png"), ("label", "png"),
                                                 ("gt", "jpg"), ("score", "png")))
    for name in written["port"]:
        if not name.endswith(".mat"):
            assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    for reader in (load_mat, jax_load_mat):
        ours, ref = reader(str(tmp_path / "port" / "meta-000012.mat")), \
            reader(str(tmp_path / "jax" / "meta-000012.mat"))
        assert ours.keys() == ref.keys() == {"intrinsic_matrix", "factor_depth", "camera_pose"}
        for key in ours:
            np.testing.assert_array_equal(ours[key], ref[key])
        np.testing.assert_array_equal(ours["intrinsic_matrix"], K)
        np.testing.assert_array_equal(ours["camera_pose"], pose.astype(np.float64))
        assert float(mat_scalar(ours["factor_depth"])) == 1000.0
    depth_back = np.asarray(Image.open(tmp_path / "port" / "depth-000012.png"))
    np.testing.assert_array_equal(depth_back,
                                  np.asarray(depth.astype(np.float64) * 1000.0, np.uint16))
