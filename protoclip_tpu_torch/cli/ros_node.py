"""Runnable ROS node entries of the port (counterpart of
``protoclip_tpu/cli/ros_node.py``) and of the reference's launcher scripts
(``toolkit/.../ros/scripts/run_proto_clip_node.sh`` and
``run_proto_clip_rviz_results_pub.sh``), which plumb config / checkpoint /
splits / ASR paths into ``proto_clip_node.py`` and
``proto_clip_results_node.py``:

    python -m protoclip_tpu_torch.cli.ros_node grasp --config configs/fewsol_198.yml \\
        --splits splits/fewsol_splits_198.json \\
        --memory_bank_v ckpt/memory_bank_v.pt --memory_bank_t ckpt/memory_bank_t.pt \\
        --adapter_weights ckpt/query_adapter.pt \\
        --verbs verbs_dictionary.txt --nouns nouns_dictionary.txt

    python -m protoclip_tpu_torch.cli.ros_node results --config configs/fewsol_198.yml \\
        --splits splits/fewsol_splits_198.json [...checkpoint flags]

Everything up to node construction (arg parsing, classifier build, tagger
build) is ROS-free and unit-testable; the node itself requires rospy
(``toolkit/ros_nodes.py``).  ``--device`` (default ``cuda``) places the
classifier; without CUDA the default raises.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="mode", required=True)
    for mode, help_ in (
        ("grasp", "speech-selected grasp target publisher (proto_clip_node.py)"),
        ("results", "periodic annotated-prediction publisher (proto_clip_results_node.py)"),
    ):
        p = sub.add_parser(mode, help=help_)
        p.add_argument("--config", required=True, help="experiment YAML")
        p.add_argument("--splits", required=True, help="split JSON (id->classname)")
        p.add_argument("--memory_bank_v", help="memory_bank_v.pt (default: cache tree)")
        p.add_argument("--memory_bank_t", help="memory_bank_t.pt")
        p.add_argument("--adapter_weights", help="query_adapter.pt")
        p.add_argument("--camera", default="Fetch")
        p.add_argument("--device", default="cuda",
                       help="torch device of the classifier (default: the card)")
        if mode == "grasp":
            p.add_argument(
                "--verbs", required=True,
                help="verbs dictionary txt (one per line)",
            )
            p.add_argument("--nouns", help="nouns dictionary txt (default: from splits)")
            p.add_argument(
                "--asr_config",
                help="asr_config.json with whisper/mic knobs (default: "
                "transcribe_stream defaults) — the launcher's "
                "--asr_config_path (run_proto_clip_node.sh)",
            )
            p.add_argument("--republish", type=int, default=10,
                           help="times to republish the selected label")
            p.add_argument("--log_dir", default="./ros-demo-logs",
                           help="prediction .npy dump directory "
                           "(ref proto_clip_classifier.py:151-156)")
        else:
            p.add_argument("--period", type=float, default=5.0,
                           help="seconds between published predictions")
    return parser


def build_classifier(args):
    """ROS-free: config + checkpoint triple -> ProtoClipClassifier on
    ``args.device``."""
    from protoclip_tpu_torch.core.config import load_config
    from protoclip_tpu_torch.toolkit.classifier import ProtoClipClassifier

    return ProtoClipClassifier(
        load_config(args.config),
        splits_path=args.splits,
        memory_bank_v_path=args.memory_bank_v,
        memory_bank_t_path=args.memory_bank_t,
        adapter_weights_path=args.adapter_weights,
        device=args.device,
    )


def build_tagger(args):
    """ROS-free (flair-gated): dictionaries -> VerbAndNounTagger (grasp
    mode).  Nouns default to the splits-file classnames, as the
    reference's static ``nouns_dictionary.txt`` was derived from them."""
    from protoclip_tpu_torch.toolkit.speech import (
        VerbAndNounTagger,
        noun_dictionary_from_splits,
    )

    if args.nouns:
        return VerbAndNounTagger(args.verbs, noun_dictionary_path=args.nouns)
    return VerbAndNounTagger(
        args.verbs, noun_set=noun_dictionary_from_splits(args.splits)
    )


def build_asr_kwargs(args) -> dict:
    """ROS-free: ``--asr_config`` JSON -> ``transcribe_stream`` kwargs
    (empty dict = library defaults when the flag is omitted)."""
    if not getattr(args, "asr_config", None):
        return {}
    from protoclip_tpu_torch.cli.transcribe import load_asr_config, stream_kwargs

    return stream_kwargs(load_asr_config(args.asr_config))


def main(argv=None) -> None:  # pragma: no cover - the node loops need ROS
    import time

    args = build_parser().parse_args(argv)
    import rospy  # before the (slow) classifier build: fail fast without ROS

    classifier = build_classifier(args)
    if args.mode == "grasp":
        from protoclip_tpu_torch.toolkit.ros_nodes import ProtoClipGraspNode

        # node registration must precede any subscriber/publisher
        # construction (ref proto_clip_node.py:36)
        rospy.init_node("proto_clip_with_asr")
        node = ProtoClipGraspNode(
            classifier, tagger=build_tagger(args),
            camera=args.camera, republish_count=args.republish,
            asr_kwargs=build_asr_kwargs(args), log_dir=args.log_dir,
        )
        while not rospy.is_shutdown():
            if node.run_once() is None:
                time.sleep(0.5)  # no frame / no match: don't busy-spin
    else:
        from protoclip_tpu_torch.toolkit.ros_nodes import ProtoClipResultsNode

        rospy.init_node("proto_clip_result_pub")  # ref results_node.py:30
        ProtoClipResultsNode(
            classifier, camera=args.camera, period_s=args.period
        ).spin()


if __name__ == "__main__":  # pragma: no cover
    main()
