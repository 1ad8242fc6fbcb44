"""EFTS-CNN: text ids -> aligned positions -> mel, inference and training.

Counterpart of `efficient_tts_tpu/models/efficient_tts.py`
(`EftsCNNConfig`, `_encode_text`, `forward`, `infer_durations`,
`infer_decode`). An inference model holds plain convs, weight norm folded
by the bridge, and not the mel prenet, mel encoder and text key, which
only the training forward uses. A model built with `training_modules=True`
holds them too, and keeps each res-conv weight norm as trainable {v, g}
(`nn/layers.py:WNConv1d`) when `cfg.use_weight_norm`; `fold_weight_norm`
makes its convs plain for inference.

Dtypes follow the JAX package: the conv stacks and linears run at
`cfg.compute_dtype` (None = f32), the IMV alignment chain is f32
throughout, the expansion α'ᵀV sums in f32, the mel prediction and the
losses are f32, and the duration cumsum of inference is f32; the decode
takes its own `compute_dtype`.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from efficient_tts_tpu_torch.losses.fastspeech import fastspeech_loss
from efficient_tts_tpu_torch.nn.blocks import ResConvBlock
from efficient_tts_tpu_torch.nn.duration_predictor import DurationPredictor
from efficient_tts_tpu_torch.nn.layers import Linear, dropout, frozen_param, leaky_relu, split_generator
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


def config_for_state_dict(cfg: EftsCNNConfig, keys) -> EftsCNNConfig:
    """`cfg` with `use_weight_norm` as a training model's state dict (its
    `keys`) holds the res-conv layers: {v, g} or plain (a folded file
    converted from the reference's)."""
    return dataclasses.replace(cfg, use_weight_norm=any(k.endswith(".v") for k in keys))


def as_dtype(dtype) -> torch.dtype | None:
    """None / 'float32' / 'f32' -> None (full precision); else a torch dtype."""
    if dtype in (None, "float32", "f32", torch.float32):
        return None
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


class EftsCNN(nn.Module):
    TRAINS = True

    def __init__(self, cfg: EftsCNNConfig, training_modules: bool = False):
        super().__init__()
        self.cfg = cfg
        c = cfg.n_channels

        def block(n_layers):
            return ResConvBlock(n_layers, c, cfg.k_size, cfg.leaky_slope,
                                weight_norm=training_modules and cfg.use_weight_norm)

        self.text_embedding = frozen_param((cfg.num_symbols, cfg.symbol_embedding_dim))
        self.text_encoder = block(cfg.n_text_encoder_layer)
        self.training_modules = training_modules
        if training_modules:
            self.text_key = Linear(c, c)
            self.mel_prenet = Linear(cfg.odim, c)
            self.mel_encoder = block(cfg.n_mel_encoder_layer)
            if cfg.use_mel_query_fc:
                self.mel_query_fc = Linear(c, c)
        # with a shared key and value, text_value is the key's module (JAX:
        # value = key); an inference model gets the key's weights there
        self.text_value = self.text_key if training_modules and cfg.share_text_encoder_key_value else Linear(c, c)
        self.decoder = block(cfg.n_decoder_layer)
        self.mel_out = Linear(c, cfg.odim)
        self.duration_predictor = DurationPredictor(c, cfg.n_duration_layer)

    def fold_weight_norm(self) -> "EftsCNN":
        """Make the model an inference model in place: every weight-normed conv
        plain (the weights of the inference bridge, bit for bit) and every
        parameter frozen. Returns the model."""
        for name in ("text_encoder", "mel_encoder", "decoder"):
            if hasattr(self, name):
                getattr(self, name).fold()
        return self.requires_grad_(False).eval()

    def embed(self, text):
        """The text embedding [B, T1, C] (a tensor-parallel copy gathers its
        channels here: `parallel/tensor_parallel.py:shard_embedding`)."""
        return F.embedding(text, self.text_embedding)

    def _embed(self, text):
        h = self.embed(text)
        cdt = as_dtype(self.cfg.compute_dtype)
        return h.to(cdt) if cdt is not None else h

    def encode_text(self, text, text_mask):
        """text ids [B, T1] -> masked text value [B, T1, C]."""
        value = self.text_value(self.text_encoder(self._embed(text)))
        return value * text_mask.to(value.dtype)[:, :, None]

    def forward(self, text, text_lengths, speech, speech_lengths, gen=None, deterministic: bool = True,
                sp=None) -> dict:
        """Training forward: text [B, T1] ids, speech [B, T2, odim] target
        mel, lengths [B] -> {loss, mel_loss, duration_loss, imv [B, T2],
        reconst_alpha [B, T1, T2], mel_pred [B, T2, odim], aligned_e [B, T1]}.
        With `deterministic=False` and a dropout rate, `gen` (a CPU
        generator) drives every dropout mask. With `sp` (a
        `parallel/sequence_parallel.py:SeqShard`) `speech` is the rank's
        frames of the mel, the frame-indexed outputs are the rank's, and the
        losses are the rank's part of the batch's."""
        cfg = self.cfg
        if not self.training_modules:
            raise RuntimeError("this EftsCNN was built for inference; build it with "
                               "training_modules=True (compat: trainable=True) to train it")
        t1, t2 = text.shape[1], speech.shape[1]
        text_mask = sequence_mask(text_lengths, t1)
        mel_mask = sequence_mask(speech_lengths, t2) if sp is None else sp.mask(speech_lengths, t2)
        text_mel_maskf = (text_mask[:, :, None] & mel_mask[:, None, :]).float()
        train = not deterministic and cfg.dropout_rate > 0
        r_text, r_mel, r_dec, r_pre, r_dur = split_generator(gen, 5) if train else (None,) * 5
        rate = cfg.dropout_rate

        h = self.text_encoder(self._embed(text), rate, r_text, deterministic)
        maskf = text_mask.to(h.dtype)[:, :, None]
        text_key = self.text_key(h)
        text_value = text_key if cfg.share_text_encoder_key_value else self.text_value(h)
        text_key, text_value = text_key * maskf, text_value * maskf

        cdt = as_dtype(cfg.compute_dtype)
        speech_c = speech.to(cdt) if cdt is not None else speech
        mel_dropout = dropout if sp is None else sp.dropout
        mel_h = mel_dropout(leaky_relu(self.mel_prenet(speech_c), cfg.leaky_slope), rate, r_pre, deterministic)
        mel_h = self.mel_encoder(mel_h, rate, r_mel, deterministic, sp=sp)
        if cfg.use_mel_query_fc:
            mel_h = self.mel_query_fc(mel_h)

        # the soft alignment and the IMV chain, f32
        alpha = scaled_dot_attention(mel_h, text_key, text_mask) * text_mel_maskf
        p = index_vector(text_mask)
        imv = (imv_from_alpha if sp is None else sp.imv_from_alpha)(alpha, p, mel_mask, text_lengths)
        e = (aligned_positions if sp is None else sp.aligned_positions)(imv, p, mel_mask, text_mask,
                                                                        sigma_e=cfg.sigma_e)
        reconst_alpha = alignment_from_positions(e, t2, sigma=cfg.sigma, mel_mask=mel_mask, text_mask=text_mask,
                                                 offset=0 if sp is None else sp.index * t2) * text_mel_maskf

        # the text values expanded to mel frames: operands in the compute dtype, f32 sums
        alpha_c = reconst_alpha.to(cdt) if cdt is not None else reconst_alpha
        expanded = torch.einsum("bst,bsc->btc", alpha_c.float(), text_value.float())
        if cdt is not None:
            expanded = expanded.to(cdt)
        expanded = expanded * mel_mask.to(expanded.dtype)[:, :, None]
        dec = self.decoder(expanded, rate, r_dec, deterministic, sp=sp)
        mel_pred = self.mel_out(dec).float() * mel_mask.float()[:, :, None]

        # the duration target: log(delta e + offset) of the detached e
        e_sg = e.detach()
        delta_e = torch.cat([e_sg[:, :1], e_sg[:, 1:] - e_sg[:, :-1]], dim=1)
        log_delta_e = torch.where(text_mask, torch.log(delta_e + cfg.duration_offset), torch.zeros_like(delta_e))
        dur_pred = self.duration_predictor(text_value, ~text_mask, rate, r_dur, deterministic).float()
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
        delta_e = self.duration_predictor.infer(
            value, pad_mask=~text_mask, offset=self.cfg.duration_offset
        )
        # f32 cumsum: bf16 would lose whole frames once e reaches a few hundred
        e = torch.cumsum(delta_e.float(), dim=1)
        return e, value, text_mask

    def infer_decode(self, value, e, text_mask, t2: int, compute_dtype=None):
        """Stage 2 at static mel length t2: (mel [B, t2, odim] f32, alpha')."""
        with span("efts.decode", device=True):
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
