"""What the grounding cells share: the configuration applied to the program
and to the reference alike, the seeded weights, and the queries."""

from __future__ import annotations

import random
from types import SimpleNamespace
from typing import Any, Dict, List

import torch

from weights import seeded_weights


def program_cfg(values: Dict[str, Any], **extra):
    """The port's config with every key of the configuration file (and
    ``extra``) applied over its defaults, frozen."""
    from vgqa_tpu_torch.config import build_default_cfg

    cfg = build_default_cfg()
    opts = []
    for k, v in {**values, **extra}.items():
        opts += [k, v]
    cfg.merge_from_list(opts)
    cfg.freeze()
    return cfg


def reference_cfg(values: Dict[str, Any]):
    """The same keys as nested attributes, for the reference's copies."""
    root = SimpleNamespace()
    for key, v in values.items():
        node = root
        *path, leaf = key.split(".")
        for p in path:
            if not hasattr(node, p):
                setattr(node, p, SimpleNamespace())
            node = getattr(node, p)
        setattr(node, leaf, v)
    return root


def reference_module(values: Dict[str, Any]):
    """The reference VSTGNet of the configuration, on the ``meta`` device."""
    from reference.vstg.vstgnet import GroundingConfig, VSTGNet

    with torch.device("meta"):
        return VSTGNet(GroundingConfig.from_cfg(reference_cfg(values)))


def reference_model(values: Dict[str, Any], seed: int, device):
    """(reference VSTGNet in float32 on ``device`` holding the seeded
    weights, the weights {name: tensor})."""
    model = reference_module(values)
    weights = seeded_weights(model, seed, device, torch.float32)
    model.load_state_dict(weights, assign=True)
    return model, weights


_SUBJECTS = ["man", "woman", "child", "dog", "cat", "adult", "baby", "horse", "bicycle",
             "car", "ball", "bird", "girl", "boy", "person"]
_ADJECTIVES = ["red", "small", "tall", "young", "white", "black", "old", "green", "blue",
               "striped"]
_VERBS = ["walks toward", "rides", "holds", "chases", "leans on", "touches", "watches",
          "pushes", "runs beside", "jumps over", "sits next to", "carries", "points at",
          "hugs", "kicks"]
_OBJECTS = ["the car", "a table", "the door", "a chair", "the sofa", "a cup", "the window",
            "a bag", "the fence", "a ball", "the stairs", "a toy", "the bench", "a box"]
_PLACES = ["in the kitchen", "on the street", "near the tree", "in the park",
           "at the beach", "inside the room", "behind the house", "on the grass"]


def declarative_queries(seed: int, n: int, lo: int = 8, hi: int = 20) -> List[str]:
    """``n`` VidSTG-style declarative queries of ``lo``-``hi`` words."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        target = rng.randint(lo, hi)
        words = ["the", rng.choice(_ADJECTIVES), rng.choice(_SUBJECTS)]
        words += rng.choice(_VERBS).split() + rng.choice(_OBJECTS).split()
        while len(words) < target:
            words += rng.choice(_PLACES + ["and then", "slowly", "quickly"]).split()
        out.append(" ".join(words[:max(target, lo)]))
    return out
