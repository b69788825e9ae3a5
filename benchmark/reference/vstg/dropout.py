"""Frozen copy of the port module named below, imports made local; kernel calls go to
``plain_kernels``.

The randomness of one training step (counterpart of flax's ``'dropout'``
PRNG stream).

``DropoutRng`` holds two explicit generators, both seeded from the step's
seed: one on the device, for dropout masks and DropPath gates (so no mask
crosses from the host), and one on the CPU, from which each call of the
K3 kernel draws its int32 seed (an int on the host, so no device sync).
A forward that receives ``rng=None`` is deterministic (eval mode).

Under data parallelism each process folds its rank into both seeds, so the
videos of different ranks get different masks, as the videos of one global
batch do in the JAX package; rank 0 draws what a single process draws.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

import torch


def rank_seed(seed: int, rank: int) -> int:
    """``seed`` with the data-parallel ``rank`` folded in: rank 0 keeps
    ``seed``; another rank takes 62 bits of a hash of both, so its low 32
    bits (all the CPU generator reads) differ too."""
    if rank == 0:
        return int(seed)
    digest = hashlib.sha256(f"{int(seed)}/{int(rank)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 2


class DropoutRng:
    def __init__(self, seed: int, device, rank: int = 0):
        device = torch.device(device)
        seed = rank_seed(seed, rank)
        self.host = torch.Generator().manual_seed(int(seed))
        self.device = torch.Generator(device=device).manual_seed(int(seed) + 1)

    def dropout(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        """flax ``nn.Dropout``: keep with probability 1 - rate, scale kept
        entries by 1 / (1 - rate); rate 0 is the identity."""
        if rate <= 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.device, device=x.device) < 1.0 - rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                                device=x.device))

    def bernoulli(self, p: torch.Tensor) -> torch.Tensor:
        """Boolean draws with probability ``p`` (a tensor on the device)."""
        return torch.rand(p.shape, generator=self.device, device=p.device) < p

    def seed(self) -> int:
        """An int32 kernel seed from the host generator."""
        return int(torch.randint(-2 ** 31, 2 ** 31, (), generator=self.host))

    def get_state(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.host.get_state(), self.device.get_state()

    def set_state(self, state: Tuple[torch.Tensor, torch.Tensor]) -> None:
        self.host.set_state(state[0])
        self.device.set_state(state[1])


def dropout(x: torch.Tensor, rate: float, rng: Optional[DropoutRng]) -> torch.Tensor:
    """``rng.dropout(x, rate)`` in training, the identity when ``rng`` is None."""
    return x if rng is None else rng.dropout(x, rate)
