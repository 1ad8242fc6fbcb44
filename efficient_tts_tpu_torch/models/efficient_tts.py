"""EFTS-CNN inference: text ids -> aligned positions -> mel.

Counterpart of `efficient_tts_tpu/models/efficient_tts.py`
(`EftsCNNConfig`, `_encode_text`, `infer_durations`, `infer_decode`).
Inference only: the mel encoder, mel prenet and text key, which only the
training forward uses, are not held.

Dtypes follow the JAX package: stage 1 (`infer_durations`) runs at
`cfg.compute_dtype` (None = f32) with an f32 duration cumsum; the decode
takes its own `compute_dtype`; the alignment is f32 throughout and the mel
output is f32.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from efficient_tts_tpu_torch.nn.blocks import ResConvBlock
from efficient_tts_tpu_torch.nn.duration_predictor import DurationPredictor
from efficient_tts_tpu_torch.nn.layers import Linear, frozen_param
from efficient_tts_tpu_torch.ops.alignment import alignment_from_positions
from efficient_tts_tpu_torch.utils.masks import sequence_mask


@dataclasses.dataclass(frozen=True)
class EftsCNNConfig:
    """Same fields and defaults as the JAX package's `EftsCNNConfig`."""

    num_symbols: int = 148
    odim: int = 80
    symbol_embedding_dim: int = 512
    n_channels: int = 512
    n_text_encoder_layer: int = 5
    n_mel_encoder_layer: int = 3
    n_decoder_layer: int = 6
    n_duration_layer: int = 2
    k_size: int = 5
    leaky_slope: float = 0.1
    use_weight_norm: bool = True
    dropout_rate: float = 0.1
    use_masking: bool = False
    duration_offset: float = 1.0
    sigma: float = 0.01
    sigma_e: float = 0.5
    delta_e_method_1: bool = True
    share_text_encoder_key_value: bool = False
    use_mel_query_fc: bool = False
    loss_normalize: str = "frame"
    compute_dtype: str | None = None


def as_dtype(dtype) -> torch.dtype | None:
    """None / 'float32' / 'f32' -> None (full precision); else a torch dtype."""
    if dtype in (None, "float32", "f32", torch.float32):
        return None
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


class EftsCNN(nn.Module):
    TRAINS = False  # its training forward (trainable weight norm) is not ported yet

    def __init__(self, cfg: EftsCNNConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.n_channels
        self.text_embedding = frozen_param((cfg.num_symbols, cfg.symbol_embedding_dim))
        self.text_encoder = ResConvBlock(cfg.n_text_encoder_layer, c, cfg.k_size, cfg.leaky_slope)
        self.text_value = Linear(c, c)
        self.decoder = ResConvBlock(cfg.n_decoder_layer, c, cfg.k_size, cfg.leaky_slope)
        self.mel_out = Linear(c, cfg.odim)
        self.duration_predictor = DurationPredictor(c, cfg.n_duration_layer)

    def encode_text(self, text, text_mask):
        """text ids [B, T1] -> masked text value [B, T1, C]."""
        h = F.embedding(text, self.text_embedding)
        cdt = as_dtype(self.cfg.compute_dtype)
        if cdt is not None:
            h = h.to(cdt)
        value = self.text_value(self.text_encoder(h))
        return value * text_mask.to(value.dtype)[:, :, None]

    def infer_durations(self, text, text_lengths):
        """Stage 1: (e [B, T1] f32 aligned positions, text value, text mask)."""
        text_mask = sequence_mask(text_lengths, text.shape[1])
        value = self.encode_text(text, text_mask)
        delta_e = self.duration_predictor.infer(
            value, pad_mask=~text_mask, offset=self.cfg.duration_offset
        )
        # f32 cumsum: bf16 would lose whole frames once e reaches a few hundred
        e = torch.cumsum(delta_e.float(), dim=1)
        return e, value, text_mask

    def infer_decode(self, value, e, text_mask, t2: int, compute_dtype=None):
        """Stage 2 at static mel length t2: (mel [B, t2, odim] f32, alpha')."""
        reconst_alpha = alignment_from_positions(e, t2, sigma=self.cfg.sigma, text_mask=text_mask)
        cdt = as_dtype(compute_dtype)
        alpha = reconst_alpha
        if cdt is not None:
            # operands rounded to the compute dtype, f32 accumulation, one rounding
            value = value.to(cdt).float()
            alpha = alpha.to(cdt).float()
        expanded = torch.bmm(alpha.transpose(1, 2), value.float())
        if cdt is not None:
            expanded = expanded.to(cdt)
        mel = self.mel_out(self.decoder(expanded)).float()
        return mel, reconst_alpha
