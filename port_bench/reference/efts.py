"""EfficientTTS (arXiv:2012.03500): EFTS-CNN and EFTS-Transformer, inference and training.

Text ids -> text encoder -> (key, value); in training the mel encoder's
queries align to the keys (alpha), the index mapping vector (IMV) is
alpha^T p made monotone and rescaled to [0, T1 - 1], the aligned
positions e are its softmax-weighted frame indices per token, and the
reconstructed alignment alpha' (a softmax over tokens of -sigma (q - e)^2)
expands the values to frames for the decoder. Inference predicts the
durations instead: e is the cumsum of clamp(exp(d) - offset, 0), the mel
length round(e) at the last token. Losses: the masked mean square error of
the mel and the masked L1 of the log durations against log(delta e +
offset), each a mean over the batch's valid frames and tokens.

`p` is the weight tree of `port_bench/weights.py`; `cfg` a config's
`model_params`. Dropout follows `dropout.py`'s keys.
"""

from __future__ import annotations

import math

import torch

from port_bench.reference.dropout import dropout, split
from port_bench.reference.ops import Ops, layer_norm, leaky, length_mask, masked_softmax, positional_table


# ---------------------------------------------------------------------------
# shared parts


def res_conv_block(p, x, slope, ops: Ops, rate=0.0, key=None, weight_norm=False):
    """EFTS-CNN's residual convs: x + dropout(leaky(conv(x))) per layer."""
    keys = split(key, len(p["layers"])) if key is not None else [None] * len(p["layers"])
    for lp, k in zip(p["layers"], keys):
        if weight_norm:
            w = lp["g"] * lp["v"] / torch.sqrt(torch.sum(lp["v"] * lp["v"], dim=(0, 1), keepdim=True))
            lp = {"w": w, "b": lp["b"]}
        x = x + dropout(leaky(ops.conv(x, lp), slope), rate, k)
    return x


def duration_backbone(p, x, ops: Ops, rate=0.0, key=None):
    """(conv k3 -> ReLU -> LayerNorm -> dropout) per layer, then a linear to 1."""
    keys = split(key, len(p["convs"])) if key is not None else [None] * len(p["convs"])
    for cp, npar, k in zip(p["convs"], p["norms"], keys):
        x = dropout(layer_norm(torch.relu(ops.conv(x, cp)), npar), rate, k)
    return ops.linear(x, p["out"])[..., 0]


def aligned_from_durations(d_log, text_mask, offset):
    """Inference's e [B, T1]: the cumsum of clamp(exp(d) - offset, 0), pads 0."""
    delta = torch.clamp(torch.exp(d_log) - offset, min=0.0)
    return torch.cumsum(torch.where(text_mask, delta, torch.zeros_like(delta)), dim=1)


def reconstructed_alignment(e, t2, sigma, text_mask, frame_mask=None):
    """alpha' [B, T1, t2]: softmax over the valid tokens of -sigma (q - e_i)^2,
    q the frame index (0 at masked frames)."""
    q = torch.arange(t2, dtype=torch.float32, device=e.device)[None, :].expand(e.shape[0], t2)
    if frame_mask is not None:
        q = q * frame_mask
    energies = -sigma * torch.square(q[:, None, :] - e[:, :, None])
    return masked_softmax(energies, text_mask[:, :, None], dim=1)


def bucket(n: int, multiple: int, min_len: int = 32) -> int:
    """The port's static length for n: n rounded up to `multiple`, at least
    `min_len` (its text and mel buckets)."""
    return max(min_len, -(-int(n) // multiple) * multiple)


def mel_lengths_of(e, text_lengths):
    """round(e) at the last valid token, [B]."""
    return torch.round(torch.gather(e, 1, (text_lengths - 1)[:, None])[:, 0]).long()


def imv_and_positions(alpha, text_mask, mel_mask, text_lengths, sigma_e):
    """(IMV [B, T2], e [B, T1]) from the soft alignment alpha [B, T1, T2]."""
    p = torch.arange(text_mask.shape[1], device=alpha.device, dtype=torch.float32)[None, :] * text_mask
    melf = mel_mask.float()
    dummy = torch.einsum("bst,bs->bt", alpha, p)
    delta = torch.maximum(dummy[:, 1:] - dummy[:, :-1], torch.zeros((), device=alpha.device))
    imv = torch.cumsum(torch.cat([torch.zeros_like(delta[:, :1]), delta], dim=1), dim=1) * melf
    top = torch.maximum(imv.amax(dim=1), torch.tensor(1e-8, device=alpha.device))
    imv = imv * ((text_lengths.float() - 1.0) / top)[:, None]
    energies = -sigma_e * torch.square(imv[:, None, :] - p[:, :, None])
    beta = masked_softmax(energies, mel_mask[:, None, :], dim=-1)
    frame_index = torch.arange(mel_mask.shape[1], device=alpha.device, dtype=torch.float32)[None, :] * melf
    e = torch.einsum("bst,bt->bs", beta, frame_index) * text_mask
    return imv, e


def losses(mel_pred, mel, dur_pred, e, text_mask, mel_mask, offset):
    """(mel loss, duration loss): masked means over valid frames (x mel bins)
    and valid tokens."""
    e = e.detach()
    delta = torch.cat([e[:, :1], e[:, 1:] - e[:, :-1]], dim=1)
    target = torch.where(text_mask, torch.log(delta + offset), torch.zeros_like(delta))
    melf, textf = mel_mask.float()[:, :, None], text_mask.float()
    mel_loss = (torch.square(mel_pred - mel) * melf).sum() / (melf.sum() * mel.shape[-1])
    dur_loss = (torch.abs(dur_pred - target) * textf).sum() / textf.sum()
    return mel_loss, dur_loss


def _align_and_decode(value, key_t, mel_h, text_mask, mel_mask, text_lengths, cfg, ops: Ops):
    """(expanded values [B, T2, C], e) of the training forward."""
    t2 = mel_mask.shape[1]
    both = (text_mask[:, :, None] & mel_mask[:, None, :]).float()
    scores = ops.einsum("btd,bsd->bts", mel_h, key_t) / math.sqrt(mel_h.shape[-1])
    alpha = masked_softmax(scores, text_mask[:, None, :], dim=-1).transpose(1, 2) * both
    _, e = imv_and_positions(alpha, text_mask, mel_mask, text_lengths, cfg["sigma_e"])
    alpha_r = reconstructed_alignment(e, t2, cfg["sigma"], text_mask, mel_mask.float()) * both
    expanded = ops.einsum("bst,bsc->btc", alpha_r, value) * mel_mask.float()[:, :, None]
    return expanded, e


# ---------------------------------------------------------------------------
# EFTS-CNN


def cnn_stage1(p, cfg, text, text_lengths, ops: Ops) -> dict:
    """Inference's first stage on padded text [B, T1]: {"e", "value",
    "text_mask", "lengths"} (the mel lengths, round(e) at the last token)."""
    text_mask = length_mask(text_lengths, text.shape[1])
    h = res_conv_block(p["text_encoder"], p["text_embedding"]["table"][text], cfg["leaky_slope"], ops)
    value = ops.linear(h, p["text_value"]) * text_mask[:, :, None]
    e = aligned_from_durations(duration_backbone(p["duration_predictor"], value, ops), text_mask,
                               cfg["duration_offset"])
    return {"e": e, "value": value, "text_mask": text_mask, "lengths": mel_lengths_of(e, text_lengths)}


def cnn_decode(p, cfg, s1: dict, rows, t2: int, ops: Ops):
    """The second stage of `rows` of a first stage's batch at mel length t2:
    (mel [R, t2, odim] with the frames past each length zeroed, mel lengths
    [R] clipped to [1, t2])."""
    e, value, text_mask = s1["e"][rows], s1["value"][rows], s1["text_mask"][rows]
    lengths = torch.clamp(s1["lengths"][rows], 1, t2)
    alpha = reconstructed_alignment(e, t2, cfg["sigma"], text_mask)
    expanded = ops.einsum("bst,bsc->btc", alpha, value)
    mel = ops.linear(res_conv_block(p["decoder"], expanded, cfg["leaky_slope"], ops), p["mel_out"])
    return mel * length_mask(lengths, t2)[:, :, None], lengths


def cnn_train_losses(p, cfg, batch, ops: Ops, key=None):
    """EFTS-CNN's training forward on a batch: (mel loss, duration loss)."""
    rate = cfg["dropout_rate"] if key is not None else 0.0
    slope, wn = cfg["leaky_slope"], cfg.get("use_weight_norm", True)
    k_text, k_mel, k_dec, k_pre, k_dur = split(key, 5) if key is not None and rate > 0 else (None,) * 5
    text, tl, mel, ml = batch["text"], batch["text_lengths"], batch["mel"], batch["mel_lengths"]
    text_mask, mel_mask = length_mask(tl, text.shape[1]), length_mask(ml, mel.shape[1])
    tmf = text_mask.float()[:, :, None]
    h = res_conv_block(p["text_encoder"], p["text_embedding"]["table"][text], slope, ops, rate, k_text, wn)
    key_t, value = ops.linear(h, p["text_key"]) * tmf, ops.linear(h, p["text_value"]) * tmf
    mel_h = dropout(leaky(ops.linear(mel, p["mel_prenet"]), slope), rate, k_pre)
    mel_h = res_conv_block(p["mel_encoder"], mel_h, slope, ops, rate, k_mel, wn)
    expanded, e = _align_and_decode(value, key_t, mel_h, text_mask, mel_mask, tl, cfg, ops)
    dec = res_conv_block(p["decoder"], expanded, slope, ops, rate, k_dec, wn)
    mel_pred = ops.linear(dec, p["mel_out"]) * mel_mask.float()[:, :, None]
    dur = duration_backbone(p["duration_predictor"], value, ops, rate, k_dur) * text_mask
    return losses(mel_pred, mel, dur, e, text_mask, mel_mask, cfg["duration_offset"])


# ---------------------------------------------------------------------------
# EFTS-Transformer


def attention(p, x, mask, n_heads, ops: Ops, rate=0.0, key=None):
    """Self-attention with a key-padding mask [B, T] (True = valid): masked
    weights 0, attention-probability dropout."""
    b, t, d = x.shape
    dk = d // n_heads

    def heads(lp):
        return ops.linear(x, lp).view(b, t, n_heads, dk).transpose(1, 2)

    q, k, v = heads(p["q"]), heads(p["k"]), heads(p["v"])
    m = mask[:, None, None, :]
    scores = ops.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(dk)
    attn = torch.softmax(scores.masked_fill(~m, -1e30), dim=-1).masked_fill(~m, 0.0)
    ctx = ops.einsum("bhqk,bhkd->bhqd", dropout(attn, rate, key), v)
    return ops.linear(ctx.transpose(1, 2).reshape(b, t, d), p["out"])


def transformer_block(p, x, mask, cfg, ops: Ops, rate=0.0, key=None):
    """Pre-norm layers x + drop(attn(norm1 x)), x + drop(ff(norm2 x)), the
    feed-forward two k-convs around ReLU and dropout; a final LayerNorm."""
    keys = split(key, len(p["layers"])) if key is not None else [None] * len(p["layers"])
    for lp, k in zip(p["layers"], keys):
        k_attn, k_res1, k_ff, k_res2 = split(k, 4) if k is not None else (None,) * 4
        h = attention(lp["self_attn"], layer_norm(x, lp["norm1"]), mask, cfg["n_heads"], ops, rate, k_attn)
        x = x + dropout(h, rate, k_res1)
        h = layer_norm(x, lp["norm2"])
        h = ops.conv(dropout(torch.relu(ops.conv(h, lp["ff"]["conv1"])), rate, k_ff), lp["ff"]["conv2"])
        x = x + dropout(h, rate, k_res2)
    return layer_norm(x, p["final_norm"])


def transformer_train_losses(p, cfg, batch, ops: Ops, key=None):
    """EFTS-Transformer's training forward on a batch: (mel loss, duration loss)."""
    rate = cfg["dropout_rate"] if key is not None else 0.0
    k_text, k_mel, k_dec, k_dur = split(key, 4) if key is not None and rate > 0 else (None,) * 4
    text, tl, mel, ml = batch["text"], batch["text_lengths"], batch["mel"], batch["mel_lengths"]
    t1, t2, c = text.shape[1], mel.shape[1], cfg["n_channels"]
    text_mask, mel_mask = length_mask(tl, t1), length_mask(ml, t2)
    tmf = text_mask.float()[:, :, None]
    h = p["text_embedding"]["table"][text] + positional_table(t1, c, text.device) * p["pe_scale"]
    h = transformer_block(p["text_encoder"], h, text_mask, cfg, ops, rate, k_text)
    key_t, value = ops.linear(h, p["text_key"]) * tmf, ops.linear(h, p["text_value"]) * tmf
    mel_h = leaky(ops.linear(mel, p["mel_prenet"]), 0.1) + positional_table(t2, c, mel.device) * p["pe_scale"]
    mel_h = transformer_block(p["mel_encoder"], mel_h, mel_mask, cfg, ops, rate, k_mel)
    expanded, e = _align_and_decode(value, key_t, mel_h, text_mask, mel_mask, tl, cfg, ops)
    dec = transformer_block(p["decoder"], expanded, mel_mask, cfg, ops, rate, k_dec)
    mel_pred = ops.linear(dec, p["mel_out"]) * mel_mask.float()[:, :, None]
    dur = duration_backbone(p["duration_predictor"], value, ops, rate, k_dur) * text_mask
    return losses(mel_pred, mel, dur, e, text_mask, mel_mask, cfg["duration_offset"])


TRAIN_LOSSES = {"EfficientTTSCNN": cnn_train_losses, "EfficientTTSTransformer": transformer_train_losses}
