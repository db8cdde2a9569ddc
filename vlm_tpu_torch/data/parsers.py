"""Pure text→label parsers shared by the dataset classes.

The port's own copy of ``vlm_tpu/data/parsers.py``, held equal to it by
``tests/test_torch_shared_layers.py``.

These reproduce the parsing *behavior* of the reference framework
(`reference/datasets_vlm/face_dataset.py:127-198` and
`reference/datasets_vlm/mivia_par_dataset.py:93-170`) as standalone pure
functions so they are trivially testable and usable from the batched
serving path without instantiating a dataset.

Semantics preserved exactly:

- comma-split, lowercase, whitespace-stripped fields;
- missing/unparseable values → ``-1`` (``MISSING_LABEL``);
- gender: the substring ``"female"`` is checked before ``"male"``
  (`face_dataset.py:141`, `mivia_par_dataset.py:106`);
- face ethnicity: fuzzy matching with a *random tie-break* between
  "east asian" and "asian indian" when the text says only "asian"
  (`face_dataset.py:147-156`); callers that need determinism must seed
  ``random`` (the reference uses the module-global ``random`` the same way);
- color ids 1..11 with "dark" aliased to "black"
  (`mivia_par_dataset.py:29-41`), first-substring-match wins in dict order;
- age: float parse then binning to the 9 classes used across the framework
  (`face_dataset.py:35-38,191-198`).

Known reference bug, fixed here: the reference's MiviaPar parser calls
``self._parse_yesno`` which is not defined anywhere in its codebase
(`mivia_par_dataset.py:107-108`), so the surrounding ``except`` always
degrades the output to all ``-1``. We implement the evidently intended
yes/no parser (consistent with ``_to_bin_safe``, `mivia_par_dataset.py:137-146`)
so MiviaPar zero-shot evaluation is actually meaningful.
"""

from __future__ import annotations

import random
import re
from typing import Any, Dict

MISSING_LABEL = -1

# Color classes 1..11; "dark" is an alias of "black". Insertion order matters:
# matching scans in this order and the first substring hit wins
# (reference: mivia_par_dataset.py:29-41,164-170).
COLOR_LABELS: Dict[str, int] = {
    "black": 1, "dark": 1,
    "blue": 2,
    "brown": 3,
    "gray": 4,
    "green": 5,
    "orange": 6,
    "pink": 7,
    "purple": 8,
    "red": 9,
    "white": 10,
    "yellow": 11,
}

# reference: face_dataset.py:22-28
ETHNICITY_LABELS: Dict[str, int] = {
    "caucasian latin": 0,
    "caucasian": 0,
    "african american": 1,
    "east asian": 2,
    "asian indian": 3,
}

# reference: face_dataset.py:30-33
EMOTION_LABELS: Dict[str, int] = {
    "surprise": 0, "fear": 1, "disgust": 2, "happiness": 3,
    "sadness": 4, "anger": 5, "neutral": 6,
}

# reference: face_dataset.py:35-38
AGE_LABELS: Dict[str, int] = {
    "0-2": 0, "3-9": 1, "10-19": 2, "20-29": 3, "30-39": 4,
    "40-49": 5, "50-59": 6, "60-69": 7, "70+": 8,
}

AGE_CLASS_NAMES = ["0-2", "3-9", "10-19", "20-29", "30-39",
                   "40-49", "50-59", "60-69", "70+"]

_AGE_BOUNDS = [2, 9, 19, 29, 39, 49, 59, 69, float("inf")]


def to_int_safe(v: Any, default: int = MISSING_LABEL) -> int:
    """Best-effort int conversion; NaN/None/garbage → ``default``.

    Accepts float-formatted strings ("1.0"): pandas-written CSVs (the
    reference pipeline's writer) render integer columns containing any NaN
    as floats, and those labels must still load."""
    try:
        if v is None or v != v:  # NaN check without pandas
            return default
        return int(v)
    except Exception:
        try:
            f = float(v)
            return int(f) if f == int(f) else default
        except Exception:
            return default


def to_float_safe(v: Any, default: float = -1.0) -> float:
    """Best-effort float conversion; NaN/None/garbage → ``default``."""
    try:
        if v is None or v != v:
            return default
        return float(v)
    except Exception:
        return default


def to_bin_safe(v: Any) -> int:
    """0/1/-1 from ints, digit strings, or yes/no-ish strings
    (reference: mivia_par_dataset.py:137-146)."""
    s = str(v).strip().lower()
    if s in {"1", "yes", "y", "true"}:
        return 1
    if s in {"0", "no", "n", "false"}:
        return 0
    i = to_int_safe(v)          # handles ints and "1.0"-style floats
    return 1 if i == 1 else 0 if i == 0 else MISSING_LABEL


def parse_yesno(s: str) -> int:
    """Yes/no field of the VLM answer → 1/0/-1.

    The reference calls an undefined ``_parse_yesno`` here (see module
    docstring); this is the evidently intended implementation: word match
    so e.g. "yes." or "no bag" still parse, but hedges like "unknown" or
    "none visible" do NOT count as a confident "no" — they fall through to
    -1 (missing) and are excluded from accuracy, like any unparseable
    field."""
    s = s.strip().lower()
    words = re.findall(r"[a-z]+", s)
    if "yes" in words:
        return 1
    if "no" in words:
        return 0
    return to_bin_safe(s)


def match_color(s: str) -> int:
    """Color id from free text; -1 if no color name is a substring
    (reference: mivia_par_dataset.py:164-170)."""
    for name, idx in COLOR_LABELS.items():
        if name in s:
            return idx
    return MISSING_LABEL


def color_to_id(v: Any) -> int:
    """Color id from an int-like (verbatim) or a string (lexical match)
    (reference: mivia_par_dataset.py:148-162)."""
    try:
        return int(v)
    except Exception:
        pass
    return match_color(str(v).strip().lower())


def age_float_to_class(age_val: float) -> int:
    """Float age → class 0..8; negative/unknown → -1
    (reference: face_dataset.py:191-198)."""
    if age_val < 0:
        return MISSING_LABEL
    for idx, upper in enumerate(_AGE_BOUNDS):
        if age_val <= upper:
            return idx
    return MISSING_LABEL


def parse_gender(s: str) -> int:
    """1=female, 0=male, -1 unknown. "female" is checked first because "male"
    is a substring of "female" (reference: face_dataset.py:141)."""
    return 1 if "female" in s else 0 if "male" in s else MISSING_LABEL


def parse_ethnicity(s: str, rng: random.Random | None = None) -> int:
    """Fuzzy ethnicity match with the reference's random "asian" tie-break
    (reference: face_dataset.py:147-156).

    Args:
        s: lowercase ethnicity text.
        rng: optional ``random.Random`` for deterministic tie-breaking;
             defaults to the module-global ``random`` like the reference.
    """
    choice = (rng or random).choice
    if "asian" in s and "caucasian" not in s:
        if "indian" in s:
            return ETHNICITY_LABELS["asian indian"]
        if "east" in s:
            return ETHNICITY_LABELS["east asian"]
        return choice([ETHNICITY_LABELS["east asian"],
                       ETHNICITY_LABELS["asian indian"]])
    return next((v for k, v in ETHNICITY_LABELS.items() if k in s),
                MISSING_LABEL)


def parse_emotion(s: str) -> int:
    """Emotion by substring match in label-dict order
    (reference: face_dataset.py:159)."""
    return next((v for k, v in EMOTION_LABELS.items() if k in s),
                MISSING_LABEL)


def parse_face_output(output: str, *, age_is_regression: bool = False,
                      rng: random.Random | None = None) -> Dict[str, Any]:
    """Parse a face-dataset VLM answer "Gender, Age, Ethnicity, Emotion".

    Mirrors ``FaceDataset.get_labels_from_text_output``
    (reference: face_dataset.py:127-174): <4 comma fields or any hard error
    → all-missing dict (age -1.0 when regression, else -1).
    """
    try:
        parts = [x.strip().lower() for x in str(output).split(",")]
        if len(parts) < 4:
            raise ValueError(f"incomplete output (expected 4 fields): '{output}'")
        gender_str, age_str, ethnicity_str, emotion_str = parts[:4]
        gender = parse_gender(gender_str)
        age_val = to_float_safe(age_str, default=-1.0)
        age_label = age_val if age_is_regression else age_float_to_class(age_val)
        ethnicity = parse_ethnicity(ethnicity_str, rng=rng)
        emotion = parse_emotion(emotion_str)
        return {"gender": gender, "age": age_label,
                "ethnicity": ethnicity, "emotion": emotion}
    except Exception as e:
        print(f"[WARN] VLM output parsing failed: {e}")
        return {
            "gender": MISSING_LABEL,
            "age": (-1.0 if age_is_regression else MISSING_LABEL),
            "ethnicity": MISSING_LABEL,
            "emotion": MISSING_LABEL,
        }


def parse_mivia_par_output(output: str) -> Dict[str, int]:
    """Parse a MiviaPar VLM answer "Upper, Lower, Gender, Bag, Hat".

    Mirrors ``MiviaParDataset.get_labels_from_text_output``
    (reference: mivia_par_dataset.py:93-113) with the ``_parse_yesno`` bug
    fixed (see module docstring). <5 fields or hard error → all -1.
    """
    try:
        parts = [p.strip().lower() for p in str(output).split(",")]
        if len(parts) < 5:
            raise ValueError(f"incomplete output (expected 5 fields): {output}")
        return {
            "upper": match_color(parts[0]),
            "lower": match_color(parts[1]),
            "gender": parse_gender(parts[2]),
            "bag": parse_yesno(parts[3]),
            "hat": parse_yesno(parts[4]),
        }
    except Exception as e:
        print(f"[WARN] VLM output parsing failed: {e}")
        return {"upper": -1, "lower": -1, "gender": -1, "bag": -1, "hat": -1}
