"""EFTS-Transformer inference: text ids -> aligned positions -> mel.

Counterpart of `efficient_tts_tpu/models/efficient_tts_transformer.py`
(`EftsTransformerConfig`, `_encode_text`, `infer_durations`,
`infer_decode`). The IMV alignment and the duration predictor are the
EFTS-CNN's; the text encoder and the decoder are transformer blocks, the
text side with scaled positional encodings. Inference only: the text key,
mel prenet and mel encoder, which only the training forward uses, are not
held.

The text encoder gets the key-padding mask [B, 1, T1]; the decoder gets no
mask. `cfg.attn_impl` chooses the attention path call by call
(`nn/attention.py`): with "flash" or "auto" on the card, the text encoder
runs the flash kernel when T1 is a multiple of 128 and the decoder when
the mel length t2 is.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from efficient_tts_tpu_torch.models.efficient_tts import as_dtype
from efficient_tts_tpu_torch.nn.attention import add_positional_encoding
from efficient_tts_tpu_torch.nn.duration_predictor import DurationPredictor
from efficient_tts_tpu_torch.nn.layers import Linear, frozen_param
from efficient_tts_tpu_torch.nn.transformer import TransformerBlock
from efficient_tts_tpu_torch.ops.alignment import alignment_from_positions
from efficient_tts_tpu_torch.utils.masks import sequence_mask


@dataclasses.dataclass(frozen=True)
class EftsTransformerConfig:
    """Same fields and defaults as the JAX package's `EftsTransformerConfig`."""

    num_symbols: int = 148
    odim: int = 80
    n_channels: int = 384
    n_heads: int = 4
    ff_hidden: int = 1536
    n_text_encoder_layer: int = 4
    n_mel_encoder_layer: int = 2
    n_decoder_layer: int = 4
    n_duration_layer: int = 2
    dropout_rate: float = 0.1
    use_masking: bool = True
    loss_normalize: str = "frame"
    duration_offset: float = 1.0
    sigma: float = 0.01
    sigma_e: float = 0.5
    use_conv_ff: bool = True
    kernel_size: int = 3
    compute_dtype: str | None = None
    attn_impl: str = "xla"


class EftsTransformer(nn.Module):
    def __init__(self, cfg: EftsTransformerConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.n_channels

        def block(n_layers):
            return TransformerBlock(n_layers, c, cfg.n_heads, cfg.ff_hidden, cfg.use_conv_ff, cfg.kernel_size)

        self.text_embedding = frozen_param((cfg.num_symbols, c))
        self.pe_scale = frozen_param(())
        self.text_encoder = block(cfg.n_text_encoder_layer)
        self.text_value = Linear(c, c)
        self.decoder = block(cfg.n_decoder_layer)
        self.mel_out = Linear(c, cfg.odim)
        self.duration_predictor = DurationPredictor(c, cfg.n_duration_layer)

    def encode_text(self, text, text_mask):
        """text ids [B, T1] -> masked text value [B, T1, C]."""
        h = F.embedding(text, self.text_embedding)
        cdt = as_dtype(self.cfg.compute_dtype)
        if cdt is not None:
            h = h.to(cdt)
        h = add_positional_encoding(h, scale=self.pe_scale.to(h.dtype))
        h = self.text_encoder(h, mask=text_mask[:, None, :], attn_impl=self.cfg.attn_impl)
        return self.text_value(h) * text_mask.to(h.dtype)[:, :, None]

    def infer_durations(self, text, text_lengths):
        """Stage 1: (e [B, T1] f32 aligned positions, text value, text mask)."""
        text_mask = sequence_mask(text_lengths, text.shape[1])
        value = self.encode_text(text, text_mask)
        delta_e = self.duration_predictor.infer(value, pad_mask=~text_mask, offset=self.cfg.duration_offset)
        # f32 cumsum: bf16 would lose whole frames once e reaches a few hundred
        e = torch.cumsum(delta_e.float(), dim=1)
        return e, value, text_mask

    def infer_decode(self, value, e, text_mask, t2: int, compute_dtype=None):
        """Stage 2 at static mel length t2: (mel [B, t2, odim] f32, alpha').
        `compute_dtype=torch.bfloat16` rounds the expansion's operands and
        result to bf16; the decoder's first LayerNorm brings it back to f32."""
        reconst_alpha = alignment_from_positions(e, t2, sigma=self.cfg.sigma, text_mask=text_mask)
        cdt = as_dtype(compute_dtype)
        alpha = reconst_alpha
        if cdt is not None:
            # operands rounded to the compute dtype, f32 accumulation, one rounding
            value = value.to(cdt)
            alpha = alpha.to(cdt)
        expanded = torch.bmm(alpha.float().transpose(1, 2), value.float()).to(value.dtype)
        dec = self.decoder(expanded, attn_impl=self.cfg.attn_impl)
        return self.mel_out(dec).float(), reconst_alpha
