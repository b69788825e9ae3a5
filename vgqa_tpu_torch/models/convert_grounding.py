"""Full grounding-checkpoint converter: reference VSTGNet torch state dict
-> flax-layout VSTGNet tree, and MDETR/TubeDETR warm starts.

A numpy copy of ``vgqa_tpu/models/convert_grounding.py`` (the port imports
nothing of the JAX package); ``models/convert_jax.state_dict_from_jax``
turns its trees into the port's state dicts. Dead reference parameters are
dropped on purpose: ``temporal_layers`` clones, ``fusion``,
``frame_cls``/``video_cls``/``local_pos_embed``, ``gf_mlp``/``gf_mlp2``/
``fuse_linear``/``norm2`` of the query decoder, the classifiers'
``class_embedding``/``positional_embedding`` and each Bert block's
``memory_intermediate``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .convert import (
    StateDict,
    _dense,
    _linear,
    _ln,
    convert_resnet,
    convert_roberta,
    convert_video_swin,
)


def _sub(sd: StateDict, prefix: str) -> StateDict:
    plen = len(prefix)
    return {k[plen:]: v for k, v in sd.items() if k.startswith(prefix)}


def _torch_mha(sd: StateDict, prefix: str) -> Dict:
    """torch nn.MultiheadAttention -> MultiHeadAttention(q/k/v/out_proj)."""
    w = sd[f"{prefix}.in_proj_weight"]
    b = sd[f"{prefix}.in_proj_bias"]
    d = w.shape[1]
    qw, kw, vw = w[:d], w[d : 2 * d], w[2 * d :]
    qb, kb, vb = b[:d], b[d : 2 * d], b[2 * d :]
    return {
        "q_proj": {"kernel": _linear(qw), "bias": qb},
        "k_proj": {"kernel": _linear(kw), "bias": kb},
        "v_proj": {"kernel": _linear(vw), "bias": vb},
        "out_proj": _dense(sd, f"{prefix}.out_proj"),
    }


def _conv1x1_as_dense(sd: StateDict, prefix: str) -> Dict:
    """1x1 Conv2d -> Dense (the input/feature projections,
    grounding_net.py:62,71)."""
    w = sd[f"{prefix}.weight"]  # [out, in, 1, 1]
    return {
        "kernel": np.transpose(w[:, :, 0, 0], (1, 0)),
        "bias": sd[f"{prefix}.bias"],
    }


def _mlp(sd: StateDict, prefix: str, n_layers: int) -> Dict:
    return {
        f"layers_{i}": _dense(sd, f"{prefix}.layers.{i}") for i in range(n_layers)
    }


def _bert_cross_layer(sd: StateDict, prefix: str) -> Dict:
    return {
        "attention": {
            "q_proj": _dense(sd, f"{prefix}.attention.self.query"),
            "k_proj": _dense(sd, f"{prefix}.attention.self.key"),
            "v_proj": _dense(sd, f"{prefix}.attention.self.value"),
            "out_proj": _dense(sd, f"{prefix}.attention.output.dense"),
        },
        "attention_ln": _ln(sd, f"{prefix}.attention.output.LayerNorm"),
        "intermediate": _dense(sd, f"{prefix}.hidden_intermediate.dense"),
        "output": _dense(sd, f"{prefix}.output.dense"),
        "output_ln": _ln(sd, f"{prefix}.output.LayerNorm"),
    }


def _classifier(sd: StateDict, prefix: str, n_layers: int = 2) -> Dict:
    out = {
        f"layer_ca_{i}": _bert_cross_layer(sd, f"{prefix}.layer_ca.{i}")
        for i in range(n_layers)
    }
    out["head"] = {
        "transform": _dense(sd, f"{prefix}.head.transform.dense"),
        "transform_ln": _ln(sd, f"{prefix}.head.transform.LayerNorm"),
        "decoder": {"kernel": _linear(sd[f"{prefix}.head.decoder.weight"])},
        "bias": sd[f"{prefix}.head.bias"],
    }
    return out


def _encoder_layer(sd: StateDict, prefix: str) -> Dict:
    return {
        "self_attn": _torch_mha(sd, f"{prefix}.self_attn"),
        "ffn": {
            "linear1": _dense(sd, f"{prefix}.linear1"),
            "linear2": _dense(sd, f"{prefix}.linear2"),
        },
        "norm1": _ln(sd, f"{prefix}.norm1"),
        "norm2": _ln(sd, f"{prefix}.norm2"),
    }


def _time_decoder_layer(sd: StateDict, prefix: str) -> Dict:
    return {
        "self_attn": _torch_mha(sd, f"{prefix}.self_attn"),
        "cross_attn": _torch_mha(sd, f"{prefix}.cross_attn_image"),
        "ffn": {
            "linear1": _dense(sd, f"{prefix}.linear1"),
            "linear2": _dense(sd, f"{prefix}.linear2"),
        },
        "norm1": _ln(sd, f"{prefix}.norm1"),
        "norm3": _ln(sd, f"{prefix}.norm3"),
        "norm4": _ln(sd, f"{prefix}.norm4"),
    }


def _pos_decoder_layer(sd: StateDict, prefix: str, is_first: bool) -> Dict:
    out = {
        "sa_qcontent": _dense(sd, f"{prefix}.sa_qcontent_proj"),
        "sa_qtime": _dense(sd, f"{prefix}.sa_qtime_proj"),
        "sa_qpos": _dense(sd, f"{prefix}.sa_qpos_proj"),
        "sa_kcontent": _dense(sd, f"{prefix}.sa_kcontent_proj"),
        "sa_ktime": _dense(sd, f"{prefix}.sa_ktime_proj"),
        "sa_kpos": _dense(sd, f"{prefix}.sa_kpos_proj"),
        "sa_v": _dense(sd, f"{prefix}.sa_v_proj"),
        "self_attn": _torch_mha(sd, f"{prefix}.self_attn"),
        "ca_qcontent": _dense(sd, f"{prefix}.ca_qcontent_proj"),
        "ca_kcontent": _dense(sd, f"{prefix}.ca_kcontent_proj"),
        "ca_kpos": _dense(sd, f"{prefix}.ca_kpos_proj"),
        "ca_v": _dense(sd, f"{prefix}.ca_v_proj"),
        "ca_qpos_sine": _dense(sd, f"{prefix}.ca_qpos_sine_proj"),
        # the custom concat attention has no input projections; only out_proj
        # (attention.py:42) -> our cross_out
        "cross_out": _dense(sd, f"{prefix}.cross_attn.out_proj"),
        "ffn": {
            "linear1": _dense(sd, f"{prefix}.linear1"),
            "linear2": _dense(sd, f"{prefix}.linear2"),
        },
        "norm1": _ln(sd, f"{prefix}.norm1"),
        "norm3": _ln(sd, f"{prefix}.norm3"),
        "norm4": _ln(sd, f"{prefix}.norm4"),
    }
    if is_first:
        out["ca_qpos"] = _dense(sd, f"{prefix}.ca_qpos_proj")
    return out


def mdetr_to_reference_sd(sd: StateDict) -> StateDict:
    """Rename MDETR/TubeDETR-format checkpoint keys into reference-VSTGNet
    naming, inverting the reference's warm-start load_mapping
    (the reference's vgqa/utils/checkpoint_manager.py:118-164):

    * ``backbone.0.body.*``             -> ``vis_encoder.0.body.*``
    * ``transformer.text_encoder.*``    -> ``text_encoder.body.*``
    * ``transformer.resizer.*``         -> ``text_encoder.resizer.*``
    * ``input_proj.*``                  -> ``input_proj.*``
    * ``transformer.encoder.layers.*``  -> ``ground_encoder.encoder.spatial_layers.*``
    * ``transformer.<rest>``            -> ``ground_decoder.<rest>`` (TubeDETR
      time/pos decoders; plain-MDETR decoder keys simply find no target)

    The reference's ``bbox_embed`` rule is dead (VSTGNet has no top-level
    ``bbox_embed``; its bbox head lives at ``ground_decoder.decoder.bbox_embed``
    which the ``ground_decoder`` rule already covers), so no rule here."""
    out: StateDict = {}
    enc_pre = "transformer.encoder.layers."
    for k, v in sd.items():
        if k.startswith("backbone.0.body."):
            out["vis_encoder.0.body." + k[len("backbone.0.body.") :]] = v
        elif k.startswith("transformer.text_encoder."):
            out["text_encoder.body." + k[len("transformer.text_encoder.") :]] = v
        elif k.startswith("transformer.resizer."):
            out["text_encoder.resizer." + k[len("transformer.resizer.") :]] = v
        elif k.startswith("input_proj."):
            out[k] = v
        elif k.startswith(enc_pre):
            out["ground_encoder.encoder.spatial_layers." + k[len(enc_pre) :]] = v
        elif k.startswith("transformer."):
            out["ground_decoder." + k[len("transformer.") :]] = v
    return out


def convert_mdetr_warmstart(
    sd: StateDict,
    enc_layers: int = 6,
    dec_layers: int = 6,
    resnet_depths=(3, 4, 23, 3),
    roberta_layers: int = 12,
):
    """MDETR/TubeDETR-format state dict -> partial flax params for warm start.

    Returns ``(partial_params, loaded)`` where ``partial_params`` holds only
    the components fully present in ``sd`` and ``loaded`` names them.
    Equivalent capability to the reference's MDETR key remap
    (checkpoint_manager.py:118-164), which loads with strict=False — here
    absent components are skipped per-component/per-layer instead."""
    ref = mdetr_to_reference_sd(sd)
    params: Dict = {}
    loaded = []

    def attempt(name, fn, into=None):
        try:
            tree = fn()
        except KeyError:
            return
        (into if into is not None else params)[name] = tree
        loaded.append(name)

    attempt("vis_encoder", lambda: convert_resnet(
        _sub(ref, "vis_encoder.0.body."), resnet_depths))
    attempt("text_encoder", lambda: {
        "body": convert_roberta(_sub(ref, "text_encoder.body."), roberta_layers),
        "resizer": {
            "fc": _dense(ref, "text_encoder.resizer.fc"),
            "layer_norm": _ln(ref, "text_encoder.resizer.layer_norm"),
        },
    })
    attempt("input_proj", lambda: _conv1x1_as_dense(ref, "input_proj"))

    enc: Dict = {}
    for i in range(enc_layers):
        attempt(f"layer_{i}", lambda i=i: _encoder_layer(
            ref, f"ground_encoder.encoder.spatial_layers.{i}"), into=enc)
    if enc:
        params["ground_encoder"] = enc

    dec: Dict = {}
    time_dec: Dict = {}
    pos_dec: Dict = {}
    for i in range(dec_layers):
        attempt(f"layer_{i}", lambda i=i: _time_decoder_layer(
            ref, f"ground_decoder.time_decoder.layers.{i}"), into=time_dec)
        attempt(f"layer_{i}", lambda i=i: _pos_decoder_layer(
            ref, f"ground_decoder.decoder.layers.{i}", is_first=(i == 0)),
            into=pos_dec)
    attempt("norm", lambda: _ln(ref, "ground_decoder.time_decoder.norm"),
            into=time_dec)
    for name, fn in (
        ("query_scale", lambda: _mlp(ref, "ground_decoder.decoder.query_scale", 2)),
        ("ref_point_head", lambda: _mlp(ref, "ground_decoder.decoder.ref_point_head", 2)),
        ("bbox_embed", lambda: _mlp(ref, "ground_decoder.decoder.bbox_embed", 3)),
    ):
        attempt(name, fn, into=pos_dec)
    if time_dec:
        dec["time_decoder"] = time_dec
    if pos_dec:
        dec["decoder"] = pos_dec
    for flax_name, torch_pre in (
        ("pos_fc_ln1", "ground_decoder.pos_fc.0"),
        ("pos_fc_linear", "ground_decoder.pos_fc.2"),
        ("pos_fc_ln2", "ground_decoder.pos_fc.4"),
        ("time_fc_ln1", "ground_decoder.time_fc.0"),
        ("time_fc_linear", "ground_decoder.time_fc.2"),
        ("time_fc_ln2", "ground_decoder.time_fc.4"),
    ):
        fn = _ln if flax_name.endswith(("ln1", "ln2")) else _dense
        attempt(flax_name, lambda fn=fn, p=torch_pre: fn(ref, p), into=dec)
    if dec:
        params["ground_decoder"] = dec
    return {"params": params}, loaded


def merge_partial_params(base, partial):
    """Overlay ``partial``'s leaves onto a copy of ``base`` where paths and
    shapes match; returns ``(merged, n_loaded, skipped_paths)``."""
    skipped: list = []
    n_loaded = 0

    def rec(b, p, path):
        nonlocal n_loaded
        if isinstance(p, dict):
            if not isinstance(b, dict):
                skipped.append(path)
                return b
            out = dict(b)
            for k, v in p.items():
                if k in b:
                    out[k] = rec(b[k], v, f"{path}/{k}")
                else:
                    skipped.append(f"{path}/{k}")
            return out
        if hasattr(b, "shape") and tuple(np.shape(p)) != tuple(b.shape):
            skipped.append(path)
            return b
        n_loaded += 1
        return p  # caller casts leaves (jax.tree.map(jnp.asarray, ...))

    merged = rec(base, partial, "")
    return merged, n_loaded, skipped


def convert_grounding_head(
    sd: StateDict,
    enc_layers: int = 6,
    dec_layers: int = 6,
) -> Dict:
    """The NON-tower part of the reference VSTGNet state dict -> flax params:
    input projections, cross-modal encoder, classifiers, both decoders, and
    the prediction-head MLPs (the towers: :func:`convert_grounding_reference`)."""
    params: Dict = {}
    params["input_proj"] = _conv1x1_as_dense(sd, "input_proj")
    params["input_proj2"] = _conv1x1_as_dense(sd, "input_proj2")

    enc = {
        f"layer_{i}": _encoder_layer(sd, f"ground_encoder.encoder.spatial_layers.{i}")
        for i in range(enc_layers)
    }
    enc["norm"] = _ln(sd, "ground_encoder.encoder.norm")
    params["ground_encoder"] = enc

    for name in ("s_temporal_clas", "t_temporal_clas",
                 "s_spatial_clas", "t_spatial_clas"):
        params[name] = _classifier(sd, name)

    dec: Dict = {
        "time_decoder": {
            **{
                f"layer_{i}": _time_decoder_layer(
                    sd, f"ground_decoder.time_decoder.layers.{i}"
                )
                for i in range(dec_layers)
            },
            "norm": _ln(sd, "ground_decoder.time_decoder.norm"),
        },
        "decoder": {
            **{
                f"layer_{i}": _pos_decoder_layer(
                    sd, f"ground_decoder.decoder.layers.{i}", is_first=(i == 0)
                )
                for i in range(dec_layers)
            },
            "query_scale": _mlp(sd, "ground_decoder.decoder.query_scale", 2),
            "ref_point_head": _mlp(sd, "ground_decoder.decoder.ref_point_head", 2),
            "bbox_embed": _mlp(sd, "ground_decoder.decoder.bbox_embed", 3),
        },
        # pos_fc / time_fc Sequential indices 0/2/4 = LN/Linear/LN
        # (query_decoder.py:53-67)
        "pos_fc_ln1": _ln(sd, "ground_decoder.pos_fc.0"),
        "pos_fc_linear": _dense(sd, "ground_decoder.pos_fc.2"),
        "pos_fc_ln2": _ln(sd, "ground_decoder.pos_fc.4"),
        "time_fc_ln1": _ln(sd, "ground_decoder.time_fc.0"),
        "time_fc_linear": _dense(sd, "ground_decoder.time_fc.2"),
        "time_fc_ln2": _ln(sd, "ground_decoder.time_fc.4"),
    }
    params["ground_decoder"] = dec

    params["temp_embed"] = _mlp(sd, "temp_embed", 2)
    params["action_embed"] = _mlp(sd, "action_embed", 2)
    return params


def convert_grounding_reference(
    sd: StateDict,
    enc_layers: int = 6,
    dec_layers: int = 6,
    resnet_depths=(3, 4, 23, 3),
    swin_depths=(2, 2, 6, 2),
    roberta_layers: int = 12,
) -> Dict:
    """Reference VSTGNet state dict -> {'params': ...} for our VSTGNet."""
    params = convert_grounding_head(sd, enc_layers, dec_layers)

    params["vis_encoder"] = convert_resnet(
        _sub(sd, "vis_encoder.0.body."), resnet_depths
    )
    params["vid"] = convert_video_swin(_sub(sd, "vid."), swin_depths)
    params["text_encoder"] = {
        "body": convert_roberta(_sub(sd, "text_encoder.body."), roberta_layers),
        "resizer": {
            "fc": _dense(sd, "text_encoder.resizer.fc"),
            "layer_norm": _ln(sd, "text_encoder.resizer.layer_norm"),
        },
    }
    return {"params": params}


def reference_depths(sd: StateDict) -> Dict[str, object]:
    """The layer counts of a reference VSTGNet state dict, read from its
    keys, as :func:`convert_grounding_reference`'s keyword arguments: a
    full release gives its defaults (ResNet-101, Swin-T, RoBERTa-base, 6 + 6
    layers), a cut-down model its own. Raises ``ValueError`` naming the
    prefix of any component with no layer under it (a subtree named
    otherwise would convert to no layers at all)."""
    def count(prefix: str) -> int:
        idx = {int(k[len(prefix):].split(".")[0]) for k in sd if k.startswith(prefix)}
        if not idx:
            raise ValueError(f"no '{prefix}<i>.' key in the checkpoint: not a reference "
                             "VSTGNet state dict, or one that names this component otherwise")
        return max(idx) + 1

    return {"enc_layers": count("ground_encoder.encoder.spatial_layers."),
            "dec_layers": count("ground_decoder.time_decoder.layers."),
            "resnet_depths": tuple(count(f"vis_encoder.0.body.layer{s + 1}.") for s in range(4)),
            "swin_depths": tuple(count(f"vid.layers.{s}.blocks.") for s in range(4)),
            "roberta_layers": count("text_encoder.body.encoder.layer.")}

