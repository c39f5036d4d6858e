"""ASR CLI driven by the reference's ``asr_config.json`` schema (a copy of
``protoclip_tpu/cli/transcribe.py``).

Counterpart of the reference's runnable ASR entries
(``toolkit/.../asr/transcribe.py:16-118`` and
``transcribe_with_pos.py:17-129``), whose knobs come from a JSON config
(``asr/configs/asr_config.json``: model, non_english, energy_threshold,
record_timeout, phrase_timeout, default_microphone — loaded by the
blind-setattr ``asr_utils.py:3-8``; here the schema is validated).

Example::

    python -m protoclip_tpu_torch.cli.transcribe --config asr_config.json
    python -m protoclip_tpu_torch.cli.transcribe --config asr_config.json \
        --mode pos --verb_dict verbs.txt --splits fewsol_splits_198.json

The audio front-end (whisper + SpeechRecognition + PyAudio) stays
import-gated exactly like the reference's optional toolkit deps; config
parsing and argument plumbing are dependency-free and unit-tested.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class AsrConfig:
    """Validated view of the reference ``asr_config.json`` (all keys of the
    shipped file, same defaults; unknown keys rejected loudly rather than
    silently setattr'd like ``asr_utils.py:6-8``)."""

    model: str = "whisper-medium"
    non_english: bool = False
    energy_threshold: int = 1000
    record_timeout: float = 2.0
    phrase_timeout: float = 3.0
    default_microphone: Optional[str] = None


def load_asr_config(path: str) -> AsrConfig:
    with open(path) as fh:
        data = json.load(fh)
    if not isinstance(data, dict):
        raise ValueError(f"{path}: ASR config must be a JSON object")
    valid = {f.name for f in dataclasses.fields(AsrConfig)}
    unknown = sorted(set(data) - valid)
    if unknown:
        raise ValueError(f"{path}: unknown ASR config keys {unknown}; allowed {sorted(valid)}")
    # value TYPES too: a JSON "false" string is truthy and would silently
    # flip non_english; a quoted number would crash later with a bare
    # TypeError instead of naming the bad key here
    types = {
        "model": str,
        "non_english": bool,
        "energy_threshold": (int, float),
        "record_timeout": (int, float),
        "phrase_timeout": (int, float),
        "default_microphone": (str, type(None)),
    }
    for key, value in data.items():
        expected = types[key]
        bad = not isinstance(value, expected)
        if isinstance(value, bool) and expected is not bool:
            bad = True  # bool is an int subclass; True is not a valid count
        if bad:
            raise ValueError(
                f"{path}: ASR config key {key!r} must be "
                f"{getattr(expected, '__name__', expected)}, got {value!r}"
            )
    cfg = AsrConfig(**data)
    if cfg.energy_threshold < 0:
        raise ValueError("energy_threshold must be >= 0")
    if cfg.record_timeout <= 0 or cfg.phrase_timeout <= 0:
        raise ValueError("record/phrase timeouts must be > 0")
    return cfg


# sizes whisper ships English-only ".en" variants of; "large*"/"turbo"
# have none, so blindly appending ".en" (as the reference does at
# asr/transcribe.py:46-47 — it also crashes outright on "whisper-large-v3"
# via a two-way split unpack) would request nonexistent checkpoints
_EN_VARIANT_SIZES = frozenset({"tiny", "base", "small", "medium"})


def resolve_whisper_model(model: str, non_english: bool = False) -> str:
    """Map the config's ``whisper-<size>`` to a whisper checkpoint name:
    English-only ``.en`` variants where they exist, unless ``non_english``
    is set (ref ``asr/transcribe.py:43-47``)."""
    if not model.startswith("whisper-") or model == "whisper-":
        raise ValueError(f"unsupported ASR model {model!r} (expected 'whisper-<size>')")
    size = model.split("-", 1)[1]
    if size in _EN_VARIANT_SIZES and not non_english:
        size = size + ".en"
    return size


def stream_kwargs(cfg: AsrConfig) -> dict:
    """The ``transcribe_stream`` keyword arguments an ``AsrConfig`` implies."""
    return {
        "model_name": resolve_whisper_model(cfg.model, cfg.non_english),
        "energy_threshold": cfg.energy_threshold,
        "record_timeout": cfg.record_timeout,
        "phrase_timeout": cfg.phrase_timeout,
        "microphone_name": cfg.default_microphone,
    }


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Proto-CLIP speech transcription (whisper)"
    )
    parser.add_argument("--config", required=True, help="asr_config.json path")
    parser.add_argument(
        "--mode", choices=("plain", "pos"), default="plain",
        help="plain: print each phrase (asr/transcribe.py); pos: stop at a "
        "dictionary-valid (verb, noun) pair (asr/transcribe_with_pos.py)",
    )
    parser.add_argument("--verb_dict", help="allowed-verb wordlist (pos mode)")
    parser.add_argument("--noun_dict", help="allowed-noun wordlist (pos mode)")
    parser.add_argument(
        "--splits", help="split JSON to derive the noun dictionary from "
        "classnames (pos mode alternative to --noun_dict)",
    )
    return parser


def parse_args(argv=None) -> argparse.Namespace:
    args = build_parser().parse_args(argv)
    if args.mode == "pos":
        if not args.verb_dict:
            raise SystemExit("--mode pos requires --verb_dict")
        if not args.noun_dict and not args.splits:
            raise SystemExit("--mode pos requires --noun_dict or --splits")
    return args


def main(argv=None) -> None:  # pragma: no cover - requires microphone stack
    args = parse_args(argv)
    cfg = load_asr_config(args.config)
    from protoclip_tpu_torch.toolkit import speech

    try:
        _run(args, cfg, speech)
    except ImportError as exc:
        raise SystemExit(f"error: {exc}") from exc


def _run(args, cfg, speech) -> None:  # pragma: no cover - requires mic stack
    if cfg.default_microphone == "list":
        # reference behavior: 'list' enumerates devices and exits
        # (asr/transcribe.py:30-34)
        for name in speech.list_microphones():
            print(f'Microphone with name "{name}" found')
        return

    if args.mode == "plain":
        def on_text(text: str) -> bool:
            print(f"Transcribed text: {text}")
            return False  # run until Ctrl-C, like the reference loop

        speech.transcribe_stream(on_text, **stream_kwargs(cfg))
        return

    if args.noun_dict:
        tagger = speech.VerbAndNounTagger(args.verb_dict, args.noun_dict)
    else:
        tagger = speech.VerbAndNounTagger(
            args.verb_dict,
            noun_set=speech.noun_dictionary_from_splits(args.splits),
        )
    verb, noun = speech.transcribe_with_verb_and_noun_matching(
        tagger, **stream_kwargs(cfg)
    )
    print(f"Parsed action: {verb}, object: {noun}")


if __name__ == "__main__":  # pragma: no cover
    main()
