"""Speech command parsing: ASR (whisper) + POS tagging (flair); a copy of
``protoclip_tpu/toolkit/speech.py``.

Equivalent of the reference's ``toolkit/.../asr/`` and ``toolkit/.../pos/``:
transcribe microphone audio and extract a dictionary-validated (verb, noun)
pair — e.g. "pick up the mustard bottle" -> ("pick", "mustard bottle").

The heavy dependencies (whisper, PyAudio, flair) are optional: the tagging
*logic* (adjacent same-tag merging + dictionary validation,
ref ``pos/verb_and_noun_tagger.py:34-56``) is dependency-free and testable
with any ``(word, tag)`` source; only the flair/whisper front-ends are gated.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Tuple

WordTags = List[Tuple[str, str]]

_NOUN_TAGS = ("NN", "NNP", "NNS")
_VERB_TAG = "VB"


def merge_adjacent_same_tags(word_tags: Sequence[Tuple[str, str]]) -> WordTags:
    """Merge runs of identically-tagged words ("mustard"+"bottle" -> one NN)."""
    merged: WordTags = []
    i = 0
    while i < len(word_tags):
        word, tag = word_tags[i]
        while i + 1 < len(word_tags) and word_tags[i + 1][1] == tag:
            word += " " + word_tags[i + 1][0]
            i += 1
        merged.append((word, tag))
        i += 1
    return merged


def find_valid_noun_and_verb(
    word_tags: Sequence[Tuple[str, str]],
    allowed_verbs: set,
    allowed_nouns: set,
) -> Tuple[Optional[str], Optional[str]]:
    """Dictionary-validated (verb, noun) from tagged words
    (ref ``pos/verb_and_noun_tagger.py:34-56``)."""
    verb = noun = None
    for word, tag in merge_adjacent_same_tags(word_tags):
        if tag in _NOUN_TAGS and word in allowed_nouns:
            noun = word
        if tag == _VERB_TAG and word in allowed_verbs:
            verb = word
    return verb, noun


def load_dictionary(path: str, replace_underscores: bool = False) -> set:
    with open(path) as fh:
        words = [line.strip() for line in fh if line.strip()]
    if replace_underscores:
        words = [w.replace("_", " ") for w in words]
    return set(words)


def noun_dictionary_from_splits(splits_path: str) -> set:
    """Build the allowed-noun set from a split JSON's classnames (the
    reference ships a static 197-noun file derived the same way from the
    FewSOL-198 classes)."""
    import json

    with open(splits_path) as fh:
        data = json.load(fh)
    return {str(row[2]).replace("_", " ") for row in data.get("train", [])}


class VerbAndNounTagger:
    """flair-backed tagger (requires ``pip install flair``).

    ``noun_dictionary_path`` may be replaced by an explicit ``noun_set``
    (e.g. from :func:`noun_dictionary_from_splits`); the reference ships a
    static noun file derived from the FewSOL-198 classnames."""

    def __init__(
        self,
        verb_dictionary_path: str,
        noun_dictionary_path: Optional[str] = None,
        noun_set: Optional[set] = None,
    ):
        if (noun_dictionary_path is None) == (noun_set is None):
            raise ValueError("pass exactly one of noun_dictionary_path / noun_set")
        try:
            from flair.data import Sentence
            from flair.models import SequenceTagger
        except ImportError as exc:  # pragma: no cover - optional dep
            raise ImportError(
                "flair is required for POS tagging: pip install flair"
            ) from exc
        self._Sentence = Sentence
        self._tagger = SequenceTagger.load("flair/pos-english")
        self.allowed_verb_set = load_dictionary(verb_dictionary_path)
        self.allowed_noun_set = (
            load_dictionary(noun_dictionary_path, replace_underscores=True)
            if noun_dictionary_path is not None
            else set(noun_set)
        )

    def tag_sentence(self, text: str) -> WordTags:
        sentence = self._Sentence(text)
        self._tagger.predict(sentence)
        out: WordTags = []
        for entity in sentence.get_labels():
            word = entity.shortstring.split("/")[0].strip('"').lower()
            out.append((word, entity.value))
        return out

    def find_valid_noun_and_verb(self, text: str):
        return find_valid_noun_and_verb(
            self.tag_sentence(text), self.allowed_verb_set, self.allowed_noun_set
        )


def list_microphones() -> List[str]:  # pragma: no cover - requires PyAudio
    """Available microphone device names (ref ``asr/transcribe.py:30-34``,
    the ``default_microphone: 'list'`` escape hatch)."""
    try:
        import speech_recognition as sr
    except ImportError as exc:
        raise ImportError("microphone listing requires SpeechRecognition + PyAudio") from exc
    return list(sr.Microphone.list_microphone_names())


def transcribe_stream(
    on_text: Callable[[str], bool],
    model_name: str = "base.en",
    energy_threshold: int = 1000,
    record_timeout: float = 2.0,
    phrase_timeout: float = 3.0,
    microphone_name: Optional[str] = None,
):  # pragma: no cover - requires microphone + whisper
    """Stream microphone audio through whisper; call ``on_text`` per phrase
    until it returns True (ref ``asr/transcribe.py:16-118``).  Requires
    ``pip install openai-whisper SpeechRecognition PyAudio``.

    ``microphone_name`` selects the input device by name substring (ref
    ``transcribe.py:29-38``; the reference records at 44100 Hz and lets
    whisper resample from a wav temp file — here audio is captured at
    whisper's native 16 kHz and fed as a float array, no temp files)."""
    try:
        import queue
        from datetime import datetime, timedelta

        import speech_recognition as sr
        import whisper
    except ImportError as exc:
        raise ImportError(
            "ASR requires whisper + SpeechRecognition + PyAudio"
        ) from exc

    import numpy as np

    audio_model = whisper.load_model(model_name)
    recorder = sr.Recognizer()
    recorder.energy_threshold = energy_threshold
    recorder.dynamic_energy_threshold = False
    device_index = None
    if microphone_name:
        for idx, name in enumerate(sr.Microphone.list_microphone_names()):
            if microphone_name in name:
                device_index = idx
                break
        else:
            raise ValueError(f"no microphone matching {microphone_name!r}")
    source = sr.Microphone(sample_rate=16000, device_index=device_index)
    data_queue: "queue.Queue[bytes]" = queue.Queue()

    with source:
        recorder.adjust_for_ambient_noise(source)

    def record_callback(_, audio):
        data_queue.put(audio.get_raw_data())

    # capture the stopper: leaving the background listener running after
    # return would keep the mic stream open and enqueue audio forever
    # (unbounded queue growth + device contention on the next call)
    stop_listening = recorder.listen_in_background(
        source, record_callback, phrase_time_limit=record_timeout
    )

    try:
        phrase_time = None
        buffer = b""
        while True:
            if data_queue.empty():
                time.sleep(0.1)  # don't spin a core while the mic is silent
                continue
            now = datetime.utcnow()
            if phrase_time and now - phrase_time > timedelta(seconds=phrase_timeout):
                buffer = b""
            phrase_time = now
            while not data_queue.empty():
                buffer += data_queue.get()
            audio_np = (
                np.frombuffer(buffer, dtype=np.int16).astype(np.float32) / 32768.0
            )
            text = audio_model.transcribe(audio_np, fp16=False)["text"].strip()
            if on_text(text):
                return text
    finally:
        stop_listening(wait_for_stop=False)


def transcribe_with_verb_and_noun_matching(
    tagger: "VerbAndNounTagger", **kwargs
):  # pragma: no cover - requires microphone + whisper
    """Transcribe until a dictionary-valid (verb, noun) pair is heard
    (ref ``asr/transcribe_with_pos.py:17-129``)."""
    result = {}

    def on_text(text: str) -> bool:
        verb, noun = tagger.find_valid_noun_and_verb(text)
        if verb and noun:
            result["verb"], result["noun"] = verb, noun
            return True
        return False

    transcribe_stream(on_text, **kwargs)
    return result.get("verb"), result.get("noun")
