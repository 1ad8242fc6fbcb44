"""FLOPs of the models' forward passes, per utterance at its real lengths.

The synthesis counts are `efficient_tts_tpu_torch/utils/flops.py`'s, copied
so that the yardstick stays where a later change to the port cannot move
it: 2 * MACs of the dense formulations, a transposed conv counted in
sub-pixel form (ceil(k / u) useful taps an output), the alignment's softmax
left out. The training forwards are the benchmark's own, in the same
convention: every conv and linear, the alignment's two products (the
queries against the keys and the expansion of the values, 2 * T1 * T2 * C
each) and, for the EFTS-Transformer, attention's two products at T * T per
head group (4 * T * T * C a layer). A training step is counted as three
forwards.

Counting one utterance at its own lengths (not its batch's padded
bucket) counts the work these inputs need, so a change that stops
computing padding reads as a gain, never as a share above the peak.
"""

from __future__ import annotations

import math


def conv1d_flops(t_out: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * t_out * k * cin * cout


def generator_flops(v: dict, t_mel: int) -> float:
    """HiFi-GAN generator (V1 family) on one mel of t_mel frames."""
    ch = v["upsample_initial_channel"]
    t = t_mel
    total = conv1d_flops(t, v["num_mels"], ch, 7)
    for u, k in zip(v["upsample_rates"], v["upsample_kernel_sizes"]):
        cout = ch // 2
        t_out = t * u
        total += conv1d_flops(t_out, ch, cout, math.ceil(k / u))
        ch, t = cout, t_out
        for rk, dils in zip(v["resblock_kernel_sizes"], v["resblock_dilation_sizes"]):
            n_convs = (2 if v["resblock"] == "1" else 1) * len(dils)
            total += n_convs * conv1d_flops(t, ch, ch, rk)
    return total + conv1d_flops(t, ch, 1, 7)


def _duration_predictor(c: int, n_layers: int, t1: int) -> float:
    return n_layers * conv1d_flops(t1, c, c, 3) + conv1d_flops(t1, c, 1, 1)


def efts_cnn_infer_flops(p: dict, t1: int, t2: int) -> float:
    """EFTS-CNN's two-stage inference of one utterance."""
    c, k = p["n_channels"], p["k_size"]
    total = p["n_text_encoder_layer"] * conv1d_flops(t1, c, c, k) + 2 * conv1d_flops(t1, c, c, 1)
    total += _duration_predictor(c, p["n_duration_layer"], t1)
    total += 2.0 * t1 * t2 * c
    total += p["n_decoder_layer"] * conv1d_flops(t2, c, c, k) + conv1d_flops(t2, c, p["odim"], 1)
    return total


def efts_cnn_train_forward_flops(p: dict, t1: int, t2: int) -> float:
    """EFTS-CNN's training forward of one utterance."""
    c, k = p["n_channels"], p["k_size"]
    total = p["n_text_encoder_layer"] * conv1d_flops(t1, c, c, k) + 2 * conv1d_flops(t1, c, c, 1)
    total += conv1d_flops(t2, p["odim"], c, 1) + p["n_mel_encoder_layer"] * conv1d_flops(t2, c, c, k)
    total += 2 * 2.0 * t1 * t2 * c
    total += p["n_decoder_layer"] * conv1d_flops(t2, c, c, k) + conv1d_flops(t2, c, p["odim"], 1)
    return total + _duration_predictor(c, p["n_duration_layer"], t1)


def _transformer_layers(p: dict, n_layers: int, t: int) -> float:
    c, f, k = p["n_channels"], p["ff_hidden"], p["kernel_size"]
    per_layer = 4 * conv1d_flops(t, c, c, 1) + 4.0 * t * t * c + conv1d_flops(t, c, f, k) + conv1d_flops(t, f, c, k)
    return n_layers * per_layer


def efts_transformer_train_forward_flops(p: dict, t1: int, t2: int) -> float:
    """EFTS-Transformer's training forward of one utterance."""
    c = p["n_channels"]
    total = _transformer_layers(p, p["n_text_encoder_layer"], t1) + 2 * conv1d_flops(t1, c, c, 1)
    total += conv1d_flops(t2, p["odim"], c, 1) + _transformer_layers(p, p["n_mel_encoder_layer"], t2)
    total += 2 * 2.0 * t1 * t2 * c
    total += _transformer_layers(p, p["n_decoder_layer"], t2) + conv1d_flops(t2, c, p["odim"], 1)
    return total + _duration_predictor(c, p["n_duration_layer"], t1)


TRAIN_FORWARD = {"EfficientTTSCNN": efts_cnn_train_forward_flops,
                 "EfficientTTSTransformer": efts_transformer_train_forward_flops}


def train_step_flops(model_name: str, p: dict, text_lengths, mel_lengths) -> float:
    """A training step on one batch: three forwards of every row at its lengths."""
    fwd = TRAIN_FORWARD[model_name]
    return 3.0 * sum(fwd(p, int(a), int(b)) for a, b in zip(text_lengths, mel_lengths))


def synthesis_flops(p: dict, v: dict, text_lengths, mel_lengths) -> float:
    """Synthesis of a batch: each row's acoustic model and generator at its lengths."""
    return sum(efts_cnn_infer_flops(p, int(a), int(b)) + generator_flops(v, int(b))
               for a, b in zip(text_lengths, mel_lengths))
