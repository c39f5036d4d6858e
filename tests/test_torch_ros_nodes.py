"""The port's ROS node wiring (``toolkit/ros_nodes.py``) and its launcher CLI
(``cli/ros_node.py``) through the in-memory rospy / message_filters /
cv_bridge stand-ins of tests/test_ros_nodes.py, over the port's classifier
on the CPU, held against the JAX package's nodes on the same frames."""

import os
import time

import numpy as np
import pytest

from tests.test_ros_nodes import _frame, _Msg, fake_ros  # noqa: F401  (fake_ros: fixture)
from tests.test_toolkit import classifier_env  # noqa: F401  (pytest fixture)
from tests.test_torch_toolkit import _configs, _tiny_yaml, _triple


@pytest.fixture(scope="module")
def classifiers(classifier_env):
    from protoclip_tpu.toolkit.classifier import ProtoClipClassifier as JaxClassifier

    from protoclip_tpu_torch.toolkit import ProtoClipClassifier

    cfg, jcfg = _configs(classifier_env)
    return (ProtoClipClassifier(cfg, **_triple(classifier_env), device="cpu"),
            JaxClassifier(jcfg, **_triple(classifier_env)))


def _feed(callback, rgb, depth, label, score, encoding="32FC1"):
    callback(_Msg(rgb), _Msg(depth, encoding), _Msg(label), _Msg(score))


def test_seg_listener_matches_jax(fake_ros):
    from protoclip_tpu.toolkit.ros_nodes import SegImageListener as JaxListener

    from protoclip_tpu_torch.toolkit.ros_nodes import SegImageListener

    listener, jax_listener = SegImageListener("Fetch"), JaxListener("Fetch")
    ours, ref = fake_ros["callbacks"]
    np.testing.assert_array_equal(listener.intrinsics, jax_listener.intrinsics)
    assert listener.snapshot()[0] is None and listener.object_boxes() == []
    assert listener.bbox_frame().shape == (0, 8)

    rgb, depth_m, label, score = _frame()
    rng = np.random.default_rng(3)
    depth_var = depth_m + rng.uniform(0, 0.2, depth_m.shape).astype(np.float32)
    frames = [((depth_m * 1000).astype(np.uint16), "16UC1"), (depth_var, "32FC1")]
    for depth, encoding in frames:
        for callback in (ours, ref):
            _feed(callback, rgb, depth, label, score, encoding)
        for got, want in zip(listener.snapshot(), jax_listener.snapshot()):
            np.testing.assert_array_equal(got, want)
        boxes, jboxes = listener.object_boxes(), jax_listener.object_boxes()
        assert [m for m, _ in boxes] == [m for m, _ in jboxes] == [1, 2]
        for (_, box), (_, jbox) in zip(boxes, jboxes):
            for key in ("center", "extent", "points"):
                np.testing.assert_array_equal(box[key], jbox[key])
        np.testing.assert_array_equal(listener.bbox_frame(), jax_listener.bbox_frame())
    assert listener.bbox_frame().shape == (2, 8)
    # 16UC1 millimetres are stored as metres
    _feed(ours, rgb, (depth_m * 1000).astype(np.uint16), label, score, "16UC1")
    np.testing.assert_allclose(listener.snapshot()[1], depth_m)
    # an unsupported encoding is logged and skipped; the frame stays
    _feed(ours, rgb, depth_var, label, score, "8UC1")
    assert fake_ros["logerr"] and "8UC1" in fake_ros["logerr"][-1]
    np.testing.assert_allclose(listener.snapshot()[1], depth_m)


def test_seg_listener_save_data(fake_ros, tmp_path):
    from protoclip_tpu_torch.io.mat import load_mat
    from protoclip_tpu_torch.toolkit.ros_nodes import SegImageListener

    listener = SegImageListener("Realsense")
    with pytest.raises(RuntimeError, match="no synchronized frame"):
        listener.save_data(str(tmp_path), 0)
    rgb, depth_m, label, score = _frame()
    _feed(fake_ros["callbacks"][0], rgb, depth_m, label, score)
    meta = load_mat(listener.save_data(str(tmp_path), 3))
    np.testing.assert_array_equal(meta["intrinsic_matrix"], listener.intrinsics)
    np.testing.assert_array_equal(meta["camera_pose"], np.eye(4))
    for name in ("color", "depth", "label", "gt", "score"):
        assert any(f.startswith(f"{name}-000003.") for f in os.listdir(tmp_path)), name


def _speech(monkeypatch, noun):
    import protoclip_tpu.toolkit.speech as jax_speech

    import protoclip_tpu_torch.toolkit.speech as speech

    for module in (speech, jax_speech):
        monkeypatch.setattr(module, "transcribe_with_verb_and_noun_matching",
                            lambda tagger, **kw: ("pick", noun))


def test_grasp_node_publishes_what_the_jax_node_publishes(fake_ros, monkeypatch, classifiers,
                                                          tmp_path):
    """run_once: crops -> classify -> (faked) speech noun -> the selected
    mask id and its probability, republished; the same as the JAX node."""
    from protoclip_tpu.toolkit.ros_nodes import ProtoClipGraspNode as JaxGraspNode

    from protoclip_tpu_torch.toolkit.ros_nodes import ProtoClipGraspNode

    clf, jclf = classifiers
    node = ProtoClipGraspNode(clf, tagger=None, republish_count=2, asr_kwargs={"k": 1},
                              log_dir=str(tmp_path / "logs"))
    label_pub = fake_ros["publishers"]["/selected_seg_label"]
    score_pub = fake_ros["publishers"]["/selected_seg_score"]
    assert node.run_once() is None  # no frame yet

    rgb, depth_m, label, score = _frame(40, 48)
    _feed(fake_ros["callbacks"][0], rgb, depth_m, label, score)
    target_noun = clf.classify_objects([rgb[4:12, 4:12]])[0][0][0]
    _speech(monkeypatch, target_noun)
    monkeypatch.setattr(time, "sleep", lambda s: None)
    assert node.run_once() == target_noun
    ours = (list(label_pub.published), list(score_pub.published))
    assert len(ours[0]) == 2 and all(m in (1, 2) for m in ours[0])
    assert os.listdir(tmp_path / "logs")  # the classify call logged its prediction

    # the JAX node on the same frame: the same mask and probability
    label_pub.published.clear()
    score_pub.published.clear()
    jnode = JaxGraspNode(jclf, tagger=None, republish_count=2, log_dir=str(tmp_path / "jlogs"))
    _feed(fake_ros["callbacks"][1], rgb, depth_m, label, score)
    assert jnode.run_once() == target_noun
    assert label_pub.published == ours[0]
    np.testing.assert_allclose(score_pub.published, ours[1], atol=1e-5, rtol=0)

    _speech(monkeypatch, "nonexistent thing")
    assert node.run_once() is None
    assert len(label_pub.published) == 2


def test_results_node_publishes_the_canvas(fake_ros, monkeypatch, classifiers):
    from protoclip_tpu_torch.toolkit.robot import crop_object_images
    from protoclip_tpu_torch.toolkit.ros_nodes import ProtoClipResultsNode

    clf, _ = classifiers
    node = ProtoClipResultsNode(clf, period_s=0.0)
    rgb, depth_m, label, score = _frame(40, 48)
    _feed(fake_ros["callbacks"][0], rgb, depth_m, label, score)
    fake_ros["shutdown_after"] = 1  # one spin iteration, then shutdown
    monkeypatch.setattr(time, "sleep", lambda s: None)
    node.spin()
    (msg,) = fake_ros["publishers"]["/proto_clip_pred"].published
    crops, _ = crop_object_images(label, rgb)
    want, _ = clf.draw_image_with_top_k_images(crops, *clf.classify_objects(crops))
    assert msg.encoding == "rgb8"
    np.testing.assert_array_equal(msg.arr, np.asarray(want))


def test_ros_node_cli_plumbing(classifier_env, classifiers, tmp_path):
    """cli/ros_node.py: the JAX CLI's arguments plus ``--device`` (default
    the card); the classifier, tagger and ASR plumbing needs no ROS."""
    from protoclip_tpu.cli import ros_node as jax_cli

    from protoclip_tpu_torch.cli import ros_node

    parser = ros_node.build_parser()
    grasp = ["grasp", "--config", "c.yml", "--splits", classifier_env["splits"],
             "--verbs", "verbs.txt"]
    args = parser.parse_args(grasp)
    assert (args.mode, args.republish, args.device, args.log_dir) == (
        "grasp", 10, "cuda", "./ros-demo-logs")
    jargs = jax_cli.build_parser().parse_args(grasp)
    assert {k: v for k, v in vars(args).items() if k != "device"} == vars(jargs)
    with pytest.raises(SystemExit):  # a subcommand is required
        parser.parse_args([])

    yml = _tiny_yaml(classifier_env, tmp_path / "c.yml")
    args = parser.parse_args([
        "results", "--config", yml, "--splits", classifier_env["splits"],
        "--memory_bank_v", classifier_env["v"], "--memory_bank_t", classifier_env["t"],
        "--adapter_weights", classifier_env["a"], "--period", "2.5", "--device", "cpu"])
    assert args.period == 2.5
    clf = ros_node.build_classifier(args)
    assert clf.device.type == "cpu"
    crop = [np.random.default_rng(3).integers(0, 256, (40, 40, 3)).astype(np.uint8)]
    names, probs = clf.classify_objects(crop)
    want_names, want_probs = classifiers[0].classify_objects(crop)
    assert names == want_names
    np.testing.assert_array_equal(probs, want_probs)

    asr = tmp_path / "asr.json"
    asr.write_text('{"model": "whisper-small", "record_timeout": 1.5}')
    for extra in ([], ["--asr_config", str(asr)]):
        assert ros_node.build_asr_kwargs(parser.parse_args(grasp + extra)) == \
            jax_cli.build_asr_kwargs(jax_cli.build_parser().parse_args(grasp + extra))
    # flair is not installed: the tagger's gate raises alike in both packages
    for extra in ([], ["--nouns", "nouns.txt"]):
        with pytest.raises(ImportError, match="flair") as ours:
            ros_node.build_tagger(parser.parse_args(grasp + extra))
        with pytest.raises(ImportError) as ref:
            jax_cli.build_tagger(jax_cli.build_parser().parse_args(grasp + extra))
        assert str(ours.value) == str(ref.value)
