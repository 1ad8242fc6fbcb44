"""EFTS-Transformer: text ids -> aligned positions -> mel, inference and training.

Counterpart of `efficient_tts_tpu/models/efficient_tts_transformer.py`
(`EftsTransformerConfig`, `_encode_text`, `forward`, `infer_durations`,
`infer_decode`). The IMV alignment and the duration predictor are the
EFTS-CNN's; the text encoder and the decoder are transformer blocks, the
text side with scaled positional encodings. A model built with
`training_modules=True` also holds the text key, mel prenet and mel
encoder, which only the training forward (`forward`) uses; an inference
model does not.

The text encoder gets the key-padding mask [B, 1, T1]; the decoder gets no
mask. `cfg.attn_impl` chooses the attention path call by call
(`nn/attention.py`): with "flash" or "auto" on the card, the text encoder
runs the flash kernel when T1 is a multiple of 128 and the decoder when
the mel length t2 is. In training every block gets its key-padding mask,
and with dropout off (the kernel path) T1 = 128 and T2 = 512 put all 10
attention calls of a step on the flash kernels. Under sequence parallelism
(`forward(..., sp=)`) the mel side's 6 calls run the kernels at the rank's
T2 / m query rows against the whole T2.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from efficient_tts_tpu_torch.losses.fastspeech import fastspeech_loss
from efficient_tts_tpu_torch.models.efficient_tts import as_dtype
from efficient_tts_tpu_torch.nn.attention import add_positional_encoding
from efficient_tts_tpu_torch.nn.duration_predictor import DurationPredictor
from efficient_tts_tpu_torch.nn.layers import Linear, frozen_param, leaky_relu, split_generator
from efficient_tts_tpu_torch.nn.transformer import TransformerBlock
from efficient_tts_tpu_torch.ops.alignment import (
    aligned_positions,
    alignment_from_positions,
    imv_from_alpha,
    index_vector,
    scaled_dot_attention,
)
from efficient_tts_tpu_torch.utils.masks import sequence_mask
from efficient_tts_tpu_torch.utils.profiling import span


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
    TRAINS = True

    def __init__(self, cfg: EftsTransformerConfig, training_modules: bool = False):
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
        self.training_modules = training_modules
        if training_modules:
            self.text_key = Linear(c, c)
            self.mel_prenet = Linear(cfg.odim, c)
            self.mel_encoder = block(cfg.n_mel_encoder_layer)

    def embed(self, text):
        """The text embedding [B, T1, C] (a tensor-parallel copy gathers its
        channels here: `parallel/tensor_parallel.py:shard_embedding`)."""
        return F.embedding(text, self.text_embedding)

    def _text_hidden(self, text, text_mask, gen=None, deterministic: bool = True):
        """text ids [B, T1] -> text encoder output [B, T1, C]."""
        cfg = self.cfg
        h = self.embed(text)
        cdt = as_dtype(cfg.compute_dtype)
        if cdt is not None:
            h = h.to(cdt)
        h = add_positional_encoding(h, scale=self.pe_scale.to(h.dtype))
        return self.text_encoder(h, text_mask[:, None, :], cfg.attn_impl, cfg.dropout_rate, gen, deterministic)

    def encode_text(self, text, text_mask):
        """text ids [B, T1] -> masked text value [B, T1, C]."""
        h = self._text_hidden(text, text_mask)
        return self.text_value(h) * text_mask.to(h.dtype)[:, :, None]

    def forward(self, text, text_lengths, speech, speech_lengths, gen=None, deterministic: bool = True,
                sp=None) -> dict:
        """Training forward: text [B, T1] ids, speech [B, T2, odim] target
        mel, lengths [B] -> {loss, mel_loss, duration_loss, imv [B, T2],
        reconst_alpha [B, T1, T2], mel_pred [B, T2, odim], aligned_e [B, T1]}.
        With `deterministic=False` and a dropout rate, `gen` (a CPU
        generator) drives every dropout mask. With `sp` (a
        `parallel/sequence_parallel.py:SeqShard`) `speech` is the rank's
        frames of the mel, the frame-indexed outputs are the rank's, and the
        losses are the rank's part of the batch's (as `EftsCNN.forward`)."""
        cfg = self.cfg
        if not self.training_modules:
            raise RuntimeError("this EftsTransformer was built for inference; build it with "
                               "training_modules=True (compat: trainable=True) to train it")
        t1, t2 = text.shape[1], speech.shape[1]
        text_mask = sequence_mask(text_lengths, t1)
        mel_mask = sequence_mask(speech_lengths, t2) if sp is None else sp.mask(speech_lengths, t2)
        # the self-attention's key-padding mask: the whole sequence's frames
        key_mask = (mel_mask if sp is None else sequence_mask(speech_lengths, t2 * sp.extent))[:, None, :]
        offset = 0 if sp is None else sp.index * t2
        text_mel_maskf = (text_mask[:, :, None] & mel_mask[:, None, :]).float()
        train = not deterministic and cfg.dropout_rate > 0
        r_text, r_mel, r_dec, r_dur = split_generator(gen, 4) if train else (None,) * 4
        blk = dict(attn_impl=cfg.attn_impl, dropout_rate=cfg.dropout_rate, deterministic=deterministic)

        h = self._text_hidden(text, text_mask, r_text, deterministic)
        maskf = text_mask.to(h.dtype)[:, :, None]
        text_key = self.text_key(h) * maskf
        text_value = self.text_value(h) * maskf

        cdt = as_dtype(cfg.compute_dtype)
        speech_c = speech.to(cdt) if cdt is not None else speech
        mel_h = leaky_relu(self.mel_prenet(speech_c), 0.1)
        mel_h = add_positional_encoding(mel_h, scale=self.pe_scale.to(mel_h.dtype), offset=offset)
        mel_h = self.mel_encoder(mel_h, key_mask, gen=r_mel, sp=sp, **blk)

        alpha = scaled_dot_attention(mel_h, text_key, text_mask) * text_mel_maskf
        p = index_vector(text_mask)
        imv = (imv_from_alpha if sp is None else sp.imv_from_alpha)(alpha, p, mel_mask, text_lengths)
        e = (aligned_positions if sp is None else sp.aligned_positions)(imv, p, mel_mask, text_mask,
                                                                        sigma_e=cfg.sigma_e)
        reconst_alpha = alignment_from_positions(e, t2, sigma=cfg.sigma, mel_mask=mel_mask, text_mask=text_mask,
                                                 offset=offset) * text_mel_maskf

        alpha_c = reconst_alpha.to(cdt) if cdt is not None else reconst_alpha
        # operands in the compute dtype, f32 accumulation
        expanded = torch.einsum("bst,bsc->btc", alpha_c.float(), text_value.float())
        if cdt is not None:
            expanded = expanded.to(cdt)
        expanded = expanded * mel_mask.to(expanded.dtype)[:, :, None]
        dec = self.decoder(expanded, key_mask, gen=r_dec, sp=sp, **blk)
        mel_pred = self.mel_out(dec).float() * mel_mask.float()[:, :, None]

        # the duration target: log(delta e + offset) of the detached e
        e_sg = e.detach()
        delta_e = torch.cat([e_sg[:, :1], e_sg[:, 1:] - e_sg[:, :-1]], dim=1)
        log_delta_e = torch.where(text_mask, torch.log(delta_e + cfg.duration_offset), torch.zeros_like(delta_e))
        dur_pred = self.duration_predictor(text_value, ~text_mask, cfg.dropout_rate, r_dur, deterministic).float()
        if sp is None:
            mel_loss, dur_loss = fastspeech_loss(mel_pred, speech, dur_pred, log_delta_e, text_mask, mel_mask,
                                                 use_masking=cfg.use_masking, loss_normalize=cfg.loss_normalize)
        else:
            mel_loss, dur_loss = sp.fastspeech_loss(mel_pred, speech, dur_pred, log_delta_e, text_mask, mel_mask,
                                                    speech_lengths, use_masking=cfg.use_masking,
                                                    loss_normalize=cfg.loss_normalize)
        return {"loss": mel_loss + dur_loss, "mel_loss": mel_loss, "duration_loss": dur_loss, "imv": imv,
                "reconst_alpha": reconst_alpha, "mel_pred": mel_pred, "aligned_e": e_sg}

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
        with span("efts.decode", device=True):
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
