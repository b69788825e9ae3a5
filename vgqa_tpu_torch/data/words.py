"""Query text cleaning (counterpart of ``vgqa_tpu/data/words.py``).

The correction table is the reference's hand-curated VidSTG typo dictionary
(vgqa/data/words.py of the reference), held verbatim: other corrections
would give other tokens. ``clean_description`` reproduces the reference's
``clean_anno``: lowercase, split on non-word runs, drop tokens without a
letter, apply the corrections, re-join. ``load_corrections`` extends the
table from a JSON file.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List

SENTENCE_SPLIT_REGEX = re.compile(r"(\W+)")
_WORD_RE = re.compile(r"[A-Za-z]")

# The reference's VidSTG typo corrections, verbatim.
REPLACE_WORDS: Dict[str, str] = {
    "blacj": "black",
    "plastci": "plastic",
    "actmst": "",
    "smll": "small",
    "cothes": "clothes",
    "ywllow": "yellow",
    "yelow": "yellow",
    "awhite": "a white",
    "halmat": "helmet",
    "barball": "barbell",
    "palid": "",
    "livig": "living",
    "inwhite": "in white",
    "nissthe": "nissan",
    "jrans": "jeans",
    "hwite": "white",
    "softhe": "sofa",
    "tabble": "table",
    "bige": "big",
    "speakin": "speaking",
    "waering": "wearing",
    "hotal": "hotel",
    "playgrond": "playground",
    "dimgrey": "gray",
    "trowards": "towards",
    "yelllow": "yellow",
    "bowns": "bown",
    "outsoors": "outdoors",
    "resturant": "restaurant",
    "coloe": "color",
    "fatest": "fat",
    "classrooom": "classroom",
    "wahite": "white",
    "bkini": "bikini",
    "andult": "adult",
    "woaman": "woman",
    "touchs": "touch",
    "adutl": "adult",
    "palyground": "playground",
    "ppurple": "purple",
    "stairscase": "staircase",
    "sungalsses": "sunglasses",
    "inblack": "in black",
    "abovce": "above",
    "evenging": "evening",
    "ourdoors": "outdoors",
    "ocethe": "ocean",
    "glaasses": "glasses",
    "woamn": "woman",
    "fmale": "female",
    "withsunglasses": "with sunglasses",
    "gloden": "golden",
    "straint": "straight",
    "grabing": "grabbing",
    "sittingabove": "sitting above",
    "famle": "female",
    "childern": "children",
    "baby_seat": "baby seat",
    "inin": "in",
    "waer": "water",
    "womthe": "woman",
    "hoome": "home",
    "tiget": "tiger",
    "mthe": "man",
    "galsses": "glasses",
    "abvoe": "above",
    "wristhand": "wristband",
    "get_off": "get off",
    "thebed": "the bed",
    "halmet": "helmet",
    "theroom": "the room",
    "bibycle": "bicycle",
    "peachpuff": "pink",
    "cythe": "cyan",
    "mountarn": "mountain",
    "chidl": "child",
    "ththe": "the",
    "yeloow": "yellow",
    "iscaress": "is caress",
    "thesofa": "the sofa",
    "surboard": "surfboard",
    "wearig": "wearing",
    "blone": "blonde",
    "watche": "watch",
    "inisde": "inside",
    "wman": "woman",
    "eatting": "eating",
    "colorfuls": "colorful",
    "whhite": "white",
    "playgrouns": "playground",
    "qhite": "white",
    "roomm": "room",
    "watchs": "watches",
    "woodem": "wooden",
    "insdie": "inside",
    "whtie": "white",
    "colth": "clothes",
    "newbron": "newborn",
    "sittint": "sitting",
    "colorfu": "colorful",
    "barthroom": "bathroom",
    "claybank": "brown",
    "1another": "another",
    "clorful": "colorful",
    "blggest": "biggest",
    "photoing": "photo",
    "blck": "black",
    "clthes": "clothes",
    "insidethe": "inside the",
    "woma": "woman",
    "colthes": "clothes",
    "pnik": "pink",
    "torwards": "towards",
    "aborad": "aboard",
    "throwes": "throws",
    "varrying": "varying",
    "wathet": "blue",
    "withfew": "with few",
    "blcak": "black",
    "adule": "adult",
    "clotehs": "clothes",
    "onth": "on the",
    "coloful": "colorful",
    "inred": "in red",
    "clohtes": "clothes",
    "scoks": "socks",
    "carrys": "carry",
    "ground1": "ground",
    "pandthe": "panda",
    "wwearing": "wearing",
    "trouers": "trousers",
    "babyseat": "baby seat",
    "meetingplace": "meeting place",
    "tellow": "yellow",
    "mwn": "man",
    "holdiung": "holding",
    "woodens": "wooden",
    "stop_sign": "stop sign",
    "palegodenrod": "yellow",
    "putple": "purple",
    "waveing": "waving",
    "theshow": "the show",
    "whiet": "white",
    "audlt": "adult",
    "borwn": "brown",
    "besidethe": "beside the",
    "hulmet": "helmet",
    "next_to": "next to",
    "thegrass": "the grass",
    "chaqueta": "jacket",
    "smmall": "small",
    "geay": "gray",
    "woemen": "woman",
    "grya": "gray",
    "othere": "other",
    "brwon": "brown",
    "babt": "baby",
    "anothe": "another",
    "swmming": "swimming",
    "waeing": "wearing",
    "watarfall": "waterfall",
    "weddding": "wedding",
    "drowm": "drown",
    "kiechen": "kitchen",
    "secene": "scene",
    "puple": "purple",
    "straid": "striped",
}

_extra: Dict[str, str] = {}


def load_corrections(path: str) -> None:
    """Extend the correction table from a JSON {typo: fix} file."""
    with open(path) as f:
        _extra.update(json.load(f))


def clean_description(sentence: str) -> str:
    """The reference's clean_anno: lowercase words with a letter, corrected."""
    words: List[str] = SENTENCE_SPLIT_REGEX.split(sentence.strip())
    words = [w.lower() for w in words if len(w) > 0 and w != " "]
    words = [w for w in words if _WORD_RE.search(w)]
    out = []
    for w in words:
        fix = _extra.get(w, REPLACE_WORDS.get(w, w))
        out.append(fix)
    return " ".join(out)
