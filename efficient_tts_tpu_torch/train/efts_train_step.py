"""Train and eval steps of the acoustic models (counterpart of `efficient_tts_tpu/train/efts_train_step.py`).

`make_train_step(cfg, tx)` returns `train_step(state, batch, gen) ->
(state, metrics)`: the training forward of the model that the registry
gives for `cfg`, its gradients, and one optimizer update, under
`full_f32()` (cuBLAS and cuDNN without TF32, as the JAX reference computes
in f32). Dropout is on when `cfg.dropout_rate > 0`, driven by the CPU
generator `gen`. The metrics are device scalars: loss, mel_loss,
duration_loss and grad_norm, the global norm of the unclipped gradients.
The state is updated in place (`train/state.py`).

`accum_steps > 1` splits the batch into micro-batches, run one after the
other with one resident micro-batch of activations at a time. Before its
backward, each micro-batch's mel and duration losses are weighted by its
share of the full batch's valid mel frames and text tokens (with
`use_masking`; 1/accum_steps each without), so the summed gradient is the
full batch's, ragged lengths included, and one update follows.

No mesh and no sequence parallelism: multi-GPU training is not ported.
Entry points run on `device` ("cuda" by default) and raise without a card
unless the caller passes device="cpu".
"""

from __future__ import annotations

import numpy as np
import torch

from efficient_tts_tpu_torch.models import model_class_for
from efficient_tts_tpu_torch.train.optim import global_norm
from efficient_tts_tpu_torch.train.state import apply_updates, named_params
from efficient_tts_tpu_torch.utils.device import check_module_device, resolve_device
from efficient_tts_tpu_torch.utils.precision import full_f32

METRIC_KEYS = ("loss", "mel_loss", "duration_loss")
BATCH_DTYPES = {"text": torch.long, "text_lengths": torch.long, "mel": torch.float32, "mel_lengths": torch.long}


def batch_to_device(batch: dict, device) -> dict:
    """text [B, T1] ids, text_lengths [B], mel [B, T2, odim], mel_lengths [B]
    (numpy or torch) as tensors on `device`. A tensor already there in its
    dtype (`data/loader.py:device_prefetch` with `BATCH_DTYPES`) is taken as
    it is, not copied."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v).to(device=device, dtype=dt)
            for k, dt in BATCH_DTYPES.items() for v in (batch[k],)}


def _checked_model(model, model_cls, dev):
    if not isinstance(model, model_cls):
        raise TypeError(f"{type(model).__name__} is not the {model_cls.__name__} this step trains")
    check_module_device(model, dev)
    return model


def make_train_step(cfg, tx, accum_steps: int = 1, device="cuda"):
    dev = resolve_device(device)
    model_cls = model_class_for(cfg, training=True)
    deterministic = cfg.dropout_rate <= 0.0

    def grads_and_metrics(model, params, batch, gen, w_mel=1.0, w_dur=1.0):
        out = model(batch["text"], batch["text_lengths"], batch["mel"], batch["mel_lengths"], gen=gen,
                    deterministic=deterministic)
        mel, dur = w_mel * out["mel_loss"], w_dur * out["duration_loss"]
        loss = mel + dur
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(params.items(), grads)}
        return grads, {"loss": loss.detach(), "mel_loss": mel.detach(), "duration_loss": dur.detach()}

    def train_step(state, batch, gen=None):
        model = _checked_model(state["params"], model_cls, dev)
        if not deterministic and gen is None:
            raise ValueError(f"dropout_rate={cfg.dropout_rate} trains with dropout: pass a CPU generator")
        batch = batch_to_device(batch, dev)
        params = named_params(model)
        with full_f32():
            if accum_steps <= 1:
                grads, metrics = grads_and_metrics(model, params, batch, gen)
            else:
                grads, metrics = _accumulate(model, params, batch, gen)
            metrics["grad_norm"] = global_norm(grads.values())
            apply_updates(state, grads, tx)
        return state, metrics

    def _accumulate(model, params, batch, gen):
        b = batch["text"].shape[0]
        if b % accum_steps:
            raise ValueError(f"batch dim {b} not divisible by accum_steps={accum_steps}")
        n = b // accum_steps
        micro = [{k: v[i * n:(i + 1) * n] for k, v in batch.items()} for i in range(accum_steps)]
        if cfg.use_masking:
            mel_counts = torch.stack([m["mel_lengths"].sum() for m in micro]).float()
            dur_counts = torch.stack([m["text_lengths"].sum() for m in micro]).float()
        else:  # unmasked means divide by the padded counts, the same in every micro-batch
            mel_counts = dur_counts = torch.ones(accum_steps, device=dev)
        w_mel = mel_counts / torch.clamp(mel_counts.sum(), min=1.0)
        w_dur = dur_counts / torch.clamp(dur_counts.sum(), min=1.0)
        grads, metrics = None, None
        for i, mb in enumerate(micro):
            g, m = grads_and_metrics(model, params, mb, gen, w_mel[i], w_dur[i])
            if grads is None:
                grads, metrics = g, m
            else:
                grads = {n: grads[n] + g[n] for n in grads}
                metrics = {k: metrics[k] + m[k] for k in metrics}
        return grads, metrics

    return train_step


def make_eval_step(cfg, device="cuda"):
    """eval_step(model, batch) -> {loss, mel_loss, duration_loss, imv,
    reconst_alpha, mel_pred}: the training forward without dropout or
    gradients."""
    dev = resolve_device(device)
    model_cls = model_class_for(cfg, training=True)

    def eval_step(model, batch):
        model = _checked_model(model, model_cls, dev)
        batch = batch_to_device(batch, dev)
        with full_f32(), torch.no_grad():
            out = model(batch["text"], batch["text_lengths"], batch["mel"], batch["mel_lengths"],
                        deterministic=True)
        return {k: out[k] for k in (*METRIC_KEYS, "imv", "reconst_alpha", "mel_pred")}

    return eval_step
