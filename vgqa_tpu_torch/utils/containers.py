"""Static-shape batch containers (counterpart of ``vgqa_tpu/utils/containers.py``).

Layouts are the JAX package's: frames ``[V, T, H, W, 3]`` channels-last,
masks boolean with True = valid.
"""

from __future__ import annotations

from dataclasses import dataclass
import torch


@dataclass(frozen=True)
class VideoBatch:
    """A batch of padded video clips.

    frames:     [V, T, H, W, 3] float (normalized pixels, zero in padding)
                or uint8 (raw pixels, normalized by ``normalize_uint8_video``)
    pixel_mask: [V, H, W] bool, True where real pixels
    time_mask:  [V, T] bool, True where a real frame
    """

    frames: torch.Tensor
    pixel_mask: torch.Tensor
    time_mask: torch.Tensor

    def subsample(self, stride: int, start: int = 0) -> "VideoBatch":
        """Every ``stride``-th frame from ``start`` (the even/odd halves of
        the two-pass evaluation)."""
        return VideoBatch(self.frames[:, start::stride], self.pixel_mask,
                          self.time_mask[:, start::stride])


def normalize_uint8_video(
    video: VideoBatch, pixel_stats=None, dtype=torch.float32
) -> VideoBatch:
    """Normalize a uint8 canvas on the device and re-zero its padding.

    The host float pipeline normalizes before padding, so the letterbox band
    and time-padded frames are 0.0 in normalized space; a raw uint8 canvas
    would normalize them to -mean/std, so both masks re-zero them here."""
    mean, std = pixel_stats or ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
    dev = video.frames.device
    mean = torch.tensor(mean, dtype=torch.float32, device=dev)
    std = torch.tensor(std, dtype=torch.float32, device=dev)
    f = (video.frames.float() / 255.0 - mean) / std
    valid = (video.pixel_mask[:, None, :, :, None]
             & video.time_mask[:, :, None, None, None])
    f = torch.where(valid, f, torch.zeros((), device=dev))
    return VideoBatch(f.to(dtype), video.pixel_mask, video.time_mask)


@dataclass(frozen=True)
class TextBatch:
    """Tokenized queries padded to a static length.

    token_ids: [V, L] int64
    mask:      [V, L] bool, True where a real token
    """

    token_ids: torch.Tensor
    mask: torch.Tensor
