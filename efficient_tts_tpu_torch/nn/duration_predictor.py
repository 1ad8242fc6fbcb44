"""FastSpeech-style duration predictor.

Counterpart of `efficient_tts_tpu/nn/duration_predictor.py`: `_backbone`,
`_integrate_spk`, `duration_predictor` (training) and
`duration_predictor_infer`. n_layers x (conv k3 -> ReLU -> LayerNorm ->
dropout) -> linear -> 1; every conv takes n_chans inputs, the first too, as
in the reference. Training returns log-domain durations with pads set to
0; inference clamp(exp(d) - offset, 0), rounded with `to_round`, pads
zeroed. With a speaker table (`num_spks`, `spk_embed_dim`) the input is
conditioned first on the speaker's embedding, normalized to unit length:
"add" adds its projection to n_chans to every frame, "concat" appends it to
every frame and projects the [idim + E] frames to n_chans. The EFTS models
build the predictor without one.
"""

from __future__ import annotations

import torch
from torch import nn

from efficient_tts_tpu_torch.nn.layers import Conv1d, LayerNorm, Linear, dropout, frozen_param, split_generator


class DurationPredictor(nn.Module):
    def __init__(self, n_chans: int, n_layers: int = 2, kernel_size: int = 3, idim: int | None = None,
                 num_spks: int | None = None, spk_embed_dim: int | None = None,
                 spk_embed_integration_type: str = "add"):
        super().__init__()
        self.convs = nn.ModuleList(Conv1d(n_chans, n_chans, kernel_size) for _ in range(n_layers))
        self.norms = nn.ModuleList(LayerNorm(n_chans) for _ in range(n_layers))
        self.out = Linear(n_chans, 1)
        self.spk_embed_integration_type = spk_embed_integration_type
        self.spk_embedding = self.spk_projection = None
        if spk_embed_dim is not None:
            if num_spks is None:
                raise ValueError("num_spks has to be set.")
            if spk_embed_integration_type not in ("add", "concat"):
                raise NotImplementedError("support only add or concat.")
            self.spk_embedding = frozen_param((num_spks, spk_embed_dim))
            proj_in = spk_embed_dim if spk_embed_integration_type == "add" else (idim or n_chans) + spk_embed_dim
            self.spk_projection = Linear(proj_in, n_chans)

    def integrate_spk(self, x: torch.Tensor, spkids) -> torch.Tensor:
        """x [B, T, C] conditioned on the speakers' unit embeddings."""
        if self.spk_embedding is None:
            raise ValueError("speaker ids were given to a duration predictor without a speaker table")
        emb = self.spk_embedding[torch.as_tensor(spkids, device=x.device).long()]
        emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-12)
        if self.spk_embed_integration_type == "add":
            return x + self.spk_projection(emb)[:, None, :]
        return self.spk_projection(torch.cat([x, emb[:, None, :].expand(-1, x.shape[1], -1)], dim=-1))

    def backbone(self, x: torch.Tensor, dropout_rate: float = 0.0, gen=None,
                 deterministic: bool = True) -> torch.Tensor:
        """[B, T, C] -> log-domain durations [B, T]; one dropout per layer."""
        train = not deterministic and dropout_rate > 0
        gens = split_generator(gen, len(self.convs)) if train else [None] * len(self.convs)
        for conv, norm, g in zip(self.convs, self.norms, gens):
            x = dropout(norm(torch.relu(conv(x))), dropout_rate, g, deterministic)
        return self.out(x)[..., 0]

    def forward(self, x, pad_mask=None, dropout_rate: float = 0.0, gen=None, deterministic: bool = True,
                spkids=None):
        """Training: log-domain durations [B, T], pads (pad_mask True) -> 0."""
        if spkids is not None:
            x = self.integrate_spk(x, spkids)
        d = self.backbone(x, dropout_rate, gen, deterministic)
        if pad_mask is not None:
            d = torch.where(pad_mask, torch.zeros((), dtype=d.dtype, device=d.device), d)
        return d

    def infer(self, x, pad_mask=None, offset: float = 1.0, to_round: bool = False, spkids=None):
        """Linear-domain durations clamp(exp(d) - offset, 0), rounded half to
        even with `to_round`; pads -> 0."""
        if spkids is not None:
            x = self.integrate_spk(x, spkids)
        d = torch.clamp(torch.exp(self.backbone(x)) - offset, min=0.0)
        if to_round:
            d = torch.round(d)
        if pad_mask is not None:
            d = torch.where(pad_mask, torch.zeros_like(d), d)
        return d
