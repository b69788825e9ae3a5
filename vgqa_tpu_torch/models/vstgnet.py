"""VSTGNet, the spatio-temporal video grounding model (counterpart of
``vgqa_tpu/models/vstgnet.py``), for serving and training.

Frame selection stays a boolean ``select_mask`` (frames above theta, else
every valid frame) with masked means, and inference runs the static second
pass (re-selection from the actioness head and a second decode), as in the
JAX model. When ``use_pallas_attention`` is set, the encoder's per-frame
self-attention runs ``window_attention`` (eval) or ``flash_mha_train``
(training), and the Swin tower runs ``swin_block_canvas`` per block
(the canvas route) in eval and for a frozen tower in training: CUDA tensors
launch the hand-written kernels, CPU tensors run their plain versions. A
trainable tower in training, and any tower with the kernel routes off,
takes the module route (``SwinBlock3D.forward``), as the JAX model takes its
flax modules there.

Training (``train=True`` with a ``DropoutRng``) follows the JAX train
branch: dropout everywhere the JAX modules have it, DropPath in the Swin
tower (gates into the canvas kernel, or per block on the module route), a
frozen tower without gradient, ``detach`` where JAX has ``stop_gradient``,
no second pass, and ``aux_outputs`` per decoder layer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch
from torch import nn

from ..ops.dropout import DropoutRng
from ..ops.position_encoding import sine_position_2d, sine_position_hw_2d
from ..utils.containers import TextBatch, VideoBatch
from .decoder import QueryDecoder
from .encoder import CrossModalEncoder, SpatialActivation, TemporalSampling
from .layers import MLP, LearnedPosition2D
from .resnet import build_resnet, downsample_mask
from .roberta import RobertaConfig, TextEncoder
from .video_swin import VIDEO_SWIN_CONFIGS, VideoSwinBackbone


@dataclass(frozen=True)
class GroundingConfig:
    hidden: int = 256
    heads: int = 8
    enc_layers: int = 6
    dec_layers: int = 6
    ffn_dim: int = 2048
    dropout: float = 0.1
    theta: float = 0.45              # frame-selection threshold
    app_num: int = 20
    mot_num: int = 34
    video_max_len: int = 200
    use_learned_time_embed: bool = False
    resnet: str = "resnet101"
    resnet_dilation: bool = False
    pos_enc: str = "sine"            # sine | sineHW | learned
    swin: str = "video_swin_t_p4w7"  # "" selects the stub tower
    swin_feature_dim: int = 768
    freeze_swin: bool = True
    freeze_text: bool = False
    text: RobertaConfig = field(default_factory=RobertaConfig)
    use_aux_loss: bool = True
    use_pallas_attention: bool = False
    remat: bool = False              # per-layer gradient checkpointing

    @classmethod
    def from_cfg(cls, cfg) -> "GroundingConfig":
        m = cfg.MODEL
        text = RobertaConfig.tiny() if m.TEXT_MODEL.NUM_LAYERS else RobertaConfig()
        return cls(
            hidden=m.VSTG.HIDDEN, heads=m.VSTG.HEADS, enc_layers=m.VSTG.ENC_LAYERS,
            dec_layers=m.VSTG.DEC_LAYERS, ffn_dim=m.VSTG.FFN_DIM, dropout=m.VSTG.DROPOUT,
            app_num=cfg.DATASET.APP_NUM, mot_num=cfg.DATASET.MOT_NUM,
            video_max_len=cfg.INPUT.MAX_VIDEO_LEN,
            use_learned_time_embed=m.VSTG.USE_LEARN_TIME_EMBED,
            resnet=m.VISION_BACKBONE.NAME, resnet_dilation=m.VISION_BACKBONE.DILATION,
            pos_enc=m.VISION_BACKBONE.POS_ENC,
            swin=m.VIDEO_SWIN.MODEL_NAME if m.VIDEO_SWIN.ENABLED else "",
            swin_feature_dim=m.VIDEO_SWIN.FEATURE_DIM,
            freeze_swin=m.VIDEO_SWIN.FREEZE, freeze_text=m.TEXT_MODEL.FREEZE, text=text,
            use_aux_loss=cfg.SOLVER.USE_AUX_LOSS,
            # the JAX package's rule: sequence parallelism (MESH_SP > 1)
            # turns the kernel routes off
            use_pallas_attention=cfg.TPU.USE_PALLAS_ATTENTION and cfg.TPU.MESH_SP <= 1,
            remat=cfg.TPU.REMAT,
        )

    @classmethod
    def tiny_test(cls) -> "GroundingConfig":
        return cls(
            hidden=32, heads=4, enc_layers=2, dec_layers=2, ffn_dim=64,
            resnet="resnet_test", swin="video_swin_test", swin_feature_dim=64,
            text=RobertaConfig.tiny(), app_num=5, mot_num=7,
        )


class SwinStub(nn.Module):
    """Cheap stride-32 patch tower standing in for Video Swin."""

    def __init__(self, feature_dim: int):
        super().__init__()
        self.patch = nn.Conv2d(3, feature_dim, 32, stride=32)
        self.norm = nn.LayerNorm(feature_dim, eps=1e-5)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        V, T, H, W, _ = frames.shape
        x = self.patch(frames.reshape(V * T, H, W, 3).permute(0, 3, 1, 2))
        x = self.norm(x.permute(0, 2, 3, 1))
        return x.reshape(V, T, x.shape[1], x.shape[2], -1)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dims) -> torch.Tensor:
    """Mean of x over ``dims``, counting only mask=True positions."""
    m = mask.to(x.dtype)
    while m.dim() < x.dim():
        m = m[..., None]
    num = (x * m).sum(dims)
    den = m.expand_as(x).sum(dims).clamp(min=1.0)
    return num / den


class VSTGNet(nn.Module):
    def __init__(self, cfg: GroundingConfig):
        super().__init__()
        self.cfg = c = cfg
        self.vis_encoder = build_resnet(c.resnet, c.resnet_dilation, remat=c.remat)
        if c.swin:
            self.vid = VideoSwinBackbone(VIDEO_SWIN_CONFIGS[c.swin],
                                         use_kernels=c.use_pallas_attention)
        else:
            self.vid_stub = SwinStub(c.swin_feature_dim)
        self.text_encoder = TextEncoder(c.text, out_dim=c.hidden, freeze=c.freeze_text)
        self.input_proj = nn.Linear(self.vis_encoder.num_channels, c.hidden)
        self.input_proj2 = nn.Linear(c.swin_feature_dim, c.hidden)
        self.ground_encoder = CrossModalEncoder(c.hidden, c.enc_layers, c.heads,
                                                c.ffn_dim, use_flash=c.use_pallas_attention,
                                                dropout=c.dropout, remat=c.remat)
        self.s_temporal_clas = TemporalSampling(c.hidden)
        self.t_temporal_clas = TemporalSampling(c.hidden)
        self.s_spatial_clas = SpatialActivation(c.hidden, c.app_num)
        self.t_spatial_clas = SpatialActivation(c.hidden, c.mot_num)
        self.ground_decoder = QueryDecoder(c.hidden, c.dec_layers, c.heads, c.ffn_dim,
                                           c.video_max_len, c.use_learned_time_embed,
                                           c.dropout)
        self.temp_embed = MLP(c.hidden, c.hidden, 2, 2, dropout=0.3)
        self.action_embed = MLP(c.hidden, c.hidden, 1, 2, dropout=0.3)
        if c.pos_enc == "learned":
            self.pos_embed_2d = LearnedPosition2D(c.hidden // 2)
        elif c.pos_enc not in ("sine", "sineHW"):
            raise ValueError(f"not supported POS_ENC: {c.pos_enc}")

    def forward(self, video: VideoBatch, text: TextBatch, train: bool = False,
                rng: Optional[DropoutRng] = None) -> dict:
        """Eval (``train=False``, deterministic) or one training forward
        (``train=True``, with the step's ``rng``)."""
        c = self.cfg
        if train and rng is None:
            raise ValueError("a training forward needs the step's DropoutRng")
        if not train:
            rng = None
        V, T, H, W, _ = video.frames.shape
        res_feat = self.vis_encoder(video.frames.reshape(V * T, H, W, 3))
        h_, w_ = res_feat.shape[1:3]
        if c.swin:
            last_stage = str(len(VIDEO_SWIN_CONFIGS[c.swin].depths) - 1)
            if c.use_pallas_attention and (not train or c.freeze_swin):
                # the canvas route: the kernel has no backward, and the
                # reference runs its frozen Swin without gradient
                gates = (None if rng is None
                         else self.vid.drop_path_gates(rng, V, video.frames.device))
                with torch.no_grad():
                    swin_out = self.vid(video.frames, gates)[last_stage]
            else:
                # the module route: a trainable tower in training, or the
                # kernel routes off; a frozen tower runs without gradient
                with torch.set_grad_enabled(torch.is_grad_enabled() and not c.freeze_swin):
                    swin_out = self.vid(video.frames, route="module", rng=rng)[last_stage]
        else:
            swin_out = self.vid_stub(video.frames)
            if c.freeze_swin:
                swin_out = swin_out.detach()
        if swin_out.shape[2:4] != (h_, w_):
            raise ValueError(f"tower misalignment: resnet {h_}x{w_} vs swin "
                             f"{swin_out.shape[2]}x{swin_out.shape[3]}")
        text_tokens, _ = self.text_encoder(text.token_ids, text.mask, rng)
        return self.forward_from_towers(
            res_feat.reshape(V, T, h_, w_, -1), swin_out, text_tokens,
            video.pixel_mask, text.mask, video.time_mask, train=train, rng=rng)

    def forward_from_towers(self, res_feat, swin_out, text_tokens, pixel_mask,
                            text_mask, time_mask, train: bool = False,
                            rng: Optional[DropoutRng] = None) -> dict:
        """The grounding head chain from tower features to predictions.

        res_feat [V, T, h, w, Cr], swin_out [V, T, h, w, Cs], text_tokens
        [V, L, hidden]; pixel_mask [V, H, W], text_mask [V, L] and time_mask
        [V, T] are True = valid."""
        c = self.cfg
        V, T, h_, w_, _ = res_feat.shape
        vis_tokens = self.input_proj(res_feat).reshape(V, T, h_ * w_, c.hidden)
        swin_tokens = self.input_proj2(swin_out).reshape(V, T, h_ * w_, c.hidden)

        feat_mask = downsample_mask(pixel_mask, (h_, w_))
        if c.pos_enc == "sineHW":
            vis_pos = sine_position_hw_2d(feat_mask, num_pos_feats=c.hidden // 2)
        elif c.pos_enc == "learned":
            vis_pos = self.pos_embed_2d(h_, w_)[None].expand(V, h_, w_, c.hidden)
        else:
            vis_pos = sine_position_2d(feat_mask, num_pos_feats=c.hidden // 2)
        vis_pos = vis_pos.reshape(V, h_ * w_, c.hidden).to(vis_tokens.dtype)
        vis_mask = feat_mask.reshape(V, h_ * w_)

        enc = self.ground_encoder(vis_tokens, swin_tokens, text_tokens, vis_pos,
                                  vis_mask, text_mask, time_mask, rng)
        hw, L = enc["hw"], enc["text_len"]
        encoded = enc["encoded"]
        enc_vis = encoded[:, :, :hw]
        enc_swin = encoded[:, :, hw + L:]
        # the classifiers read detached features (stop_gradient in JAX)
        f_vis, f_swin = enc_vis.detach(), enc_swin.detach()
        f_text = masked_mean(encoded[:, :, hw:hw + L], time_mask, 1).detach()   # [V, L, d]

        logits_f_m = self.t_temporal_clas(f_swin, f_text, text_mask, rng)
        logits_f_a = self.s_temporal_clas(f_vis, f_text, text_mask, rng)
        att_seq = (torch.sigmoid(logits_f_m) + torch.sigmoid(logits_f_a)) / 2

        def selection_from(scores, thr):
            sel = (scores > thr) & time_mask
            return torch.where(sel.any(dim=-1, keepdim=True), sel, time_mask)

        def activation_and_queries(sel_mask):
            logits_r_m, att_map_t = self.t_spatial_clas(f_swin, f_text[:, :1], sel_mask, rng)
            logits_r_a, att_map_s = self.s_spatial_clas(f_vis, f_text[:, :1], sel_mask, rng)
            itq = masked_mean(enc_swin * att_map_t[..., None], sel_mask, (1, 2))
            isq = masked_mean(enc_vis * att_map_s[..., None], sel_mask, (1, 2))
            return logits_r_m, logits_r_a, itq, isq

        select_mask = selection_from(att_seq, c.theta)
        logits_r_m, logits_r_a, itq, isq = activation_and_queries(select_mask)
        outputs_pos, outputs_time = self.ground_decoder(enc, isq, itq, time_mask, rng)

        if not train:
            # inference-time re-selection from the actioness head and a second decode
            act = torch.sigmoid(self.action_embed(outputs_time[-1])[..., 0])
            select_mask = selection_from(act, 0.5)
            logits_r_m, logits_r_a, itq, isq = activation_and_queries(select_mask)
            outputs_pos, outputs_time = self.ground_decoder(enc, isq, itq, time_mask)

        sted = self.temp_embed(outputs_time, rng)
        actioness = self.action_embed(outputs_time, rng)
        out = {
            "pred_boxes": outputs_pos[-1],        # [V, T, 4] cxcywh sigmoid
            "pred_sted": sted[-1],                # [V, T, 2]
            "pred_actioness": actioness[-1],      # [V, T, 1]
            "logits_f_m": logits_f_m,
            "logits_f_a": logits_f_a,
            "logits_r_a": logits_r_a,
            "logits_r_m": logits_r_m,
            "att_sequences": att_seq,             # [V, T]
            "select_mask": select_mask,           # [V, T]
        }
        if c.use_aux_loss:
            out["aux_outputs"] = [
                {"pred_boxes": outputs_pos[i], "pred_sted": sted[i],
                 "pred_actioness": actioness[i]}
                for i in range(outputs_pos.shape[0] - 1)
            ]
        return out
