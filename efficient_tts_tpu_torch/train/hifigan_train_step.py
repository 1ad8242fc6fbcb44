"""HiFi-GAN's adversarial training step (counterpart of `efficient_tts_tpu/train/hifigan_train_step.py`).

`make_gan_train_step(...)` returns `train_step(state, batch) -> (state,
metrics)`, in JAX's order (:198-253):
  1. the spectral-norm power iteration of the MSD (u and v, once);
  2. the D loss (LSGAN on the MPD and the MSD, each one fused [2B] pass) on
     the generator's output, detached;
  3. the D update;
  4. the G loss against the *updated* discriminators: mel_loss_weight x
     the L1 of the generated audio's log-mel (on the `loss_mel_config`
     filterbank, the dataset's `mel_loss`) + feature matching + LSGAN (+
     stft_loss_weight x the multi-resolution STFT loss);
  5. the G update;
  6. the EMA e * d + p * (1 - d) of the generator, when tracked.
The generator's parameters do not change between the two updates, so one
generator forward serves both: its output detached for D, and with its
graph for G. Everything runs under `full_f32()`. `compute_dtype=
torch.bfloat16` runs the generator's and the discriminators' convs in bf16;
the parameters, the optimizer states, the mel DSP and the loss reductions
stay f32. Metrics are device scalars: d_loss, d_mpd, d_msd, g_loss, mel_l1,
fm, adv (and stft_sc, stft_mag).

The state is {"gen": {"params": HiFiGANTrainGenerator, "opt_state"},
"disc": {"params": Discriminators, "opt_state"}, "step": int[, "ema":
HiFiGANTrainGenerator]}, updated in place (`train/state.py`).
`make_gan_eval_step` folds a generator into the inference
`HiFiGANGenerator`, whose MRF stages run the card's kernels, and returns
the mel-L1 on the loss filterbank. Entry points run on `device` ("cuda" by
default) and raise without a card unless the caller passes device="cpu".

Over ranks (JAX :72-102): `shard_gan_state` holds the generator, its
optimizer state and the EMA column-parallel over 'model' (`parallel/
sharding.py:shard_module(trainable=True)`), the MPD, the MSD and theirs
replicated; `make_gan_train_step(..., mesh=)` takes this rank's block of
rows, weights the batch-mean losses by 1 / data extent and sums the D and
the G gradients over the data group before each update (the replicated
leaves' averaged over the model group: `agree_replicated`), so every rank's
replicated tensors, spectral norm's u and v included, stay equal. The
metrics are the global ones on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from efficient_tts_tpu_torch import compat, init
from efficient_tts_tpu_torch.dsp.mel import MelConfig, loss_mel_config, mel_spectrogram
from efficient_tts_tpu_torch.losses.gan import discriminator_loss, feature_loss, generator_loss
from efficient_tts_tpu_torch.losses.stft_loss import multi_resolution_stft_loss
from efficient_tts_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
from efficient_tts_tpu_torch.models.hifigan_train import HiFiGANTrainGenerator
from efficient_tts_tpu_torch.parallel.distributed import all_reduce_tensors
from efficient_tts_tpu_torch.parallel.mesh import DATA_AXIS
from efficient_tts_tpu_torch.parallel.sharding import agree_replicated, shard_module, sharded_names
from efficient_tts_tpu_torch.train.state import named_params
from efficient_tts_tpu_torch.utils.device import check_module_device, resolve_device
from efficient_tts_tpu_torch.utils.precision import full_f32

BATCH_KEYS = ("mel", "audio", "mel_loss")


def init_gan_state(seed: int, voc_cfg: HiFiGANConfig, gen_tx, disc_tx, ema_decay: float | None = None,
                   device="cuda") -> dict:
    """A GAN state from the seeded numpy init (`init.py`); with `ema_decay`
    it tracks an EMA generator, starting at the generator's weights."""
    return compat.gan_state_from_jax(init.init_gan_state(seed, voc_cfg, ema=ema_decay is not None), voc_cfg,
                                     gen_tx, disc_tx, device=device)


def shard_gan_state(seed: int, voc_cfg: HiFiGANConfig, gen_tx, disc_tx, mesh, ema_decay: float | None = None,
                    device="cuda") -> dict:
    """`init_gan_state` placed on `mesh`: the generator (and the EMA) as this
    rank's column-parallel copy, its optimizer moments made from the rank's
    slices; the discriminators and their optimizer state whole."""
    state = init_gan_state(seed, voc_cfg, gen_tx, disc_tx, ema_decay=ema_decay, device=device)
    gen = shard_module(state["gen"]["params"], mesh, trainable=True)
    state["gen"] = {"params": gen, "opt_state": gen_tx.init(named_params(gen))}
    if "ema" in state:
        state["ema"] = shard_module(state["ema"], mesh, trainable=True)
    return state


def ema_generator(state: dict) -> HiFiGANTrainGenerator:
    """The generator of evaluation and serving: the EMA copy when tracked."""
    return state.get("ema", state["gen"]["params"])


def batch_to_device(batch: dict, device) -> dict:
    """mel [B, F, n_mels], audio [B, S], mel_loss [B, F, n_mels] (numpy or
    tensors) as f32 tensors on `device`, taken as they are when already there."""
    return {k: torch.as_tensor(np.asarray(batch[k]) if not torch.is_tensor(batch[k]) else batch[k])
            .to(device=device, dtype=torch.float32) for k in BATCH_KEYS}


def _apply(module, grads: dict, opt_state: dict, tx) -> dict:
    params = named_params(module)
    updates, opt_state = tx.update(grads, opt_state, params)
    for n, u in updates.items():
        params[n].add_(u)
    return opt_state


def _grads(loss, params: dict) -> dict:
    gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(params.items(), gs)}


def _log_mel(y, cfg):
    """[B, T] -> [B, F, n_mels], the loss filterbank's log-mel."""
    return mel_spectrogram(y, cfg).transpose(1, 2)


def make_gan_train_step(voc_cfg: HiFiGANConfig, gen_tx, disc_tx, mel_cfg: MelConfig = MelConfig(),
                        mel_loss_weight: float = 45.0, use_stft_loss: bool = False, stft_loss_weight: float = 1.0,
                        ema_decay: float | None = None, compute_dtype=None, fmax_loss: float | None = None,
                        device="cuda", mesh=None):
    dev = resolve_device(device)
    loss_cfg = loss_mel_config(mel_cfg, fmax_loss)
    cdt = compute_dtype
    data_group = mesh.data_group if mesh is not None and mesh.shape[DATA_AXIS] > 1 else None
    share = 1.0 / mesh.shape[DATA_AXIS] if data_group is not None else 1.0

    def summed(grads, module):
        if data_group is not None:
            grads = all_reduce_tensors(grads, data_group)
        if mesh is None:
            return grads
        return agree_replicated(grads, sharded_names(module), mesh)

    def train_step(state, batch):
        gen, disc = state["gen"]["params"], state["disc"]["params"]
        if not isinstance(gen, HiFiGANTrainGenerator) or gen.cfg != voc_cfg:
            raise TypeError(f"train_step trains a HiFiGANTrainGenerator of {voc_cfg}")
        for m in (gen, disc, state.get("ema", gen)):
            check_module_device(m, dev)
        if ema_decay is not None and "ema" not in state:
            raise ValueError("ema_decay is set but the state tracks no EMA generator")
        batch = batch_to_device(batch, dev)
        y, mel_target = batch["audio"], batch["mel_loss"]
        g_params, d_params = named_params(gen), named_params(disc)
        with full_f32():
            disc.msd.power_iteration()
            y_hat = gen(batch["mel"], cdt)

            # the discriminators on the detached generator output
            mpd_r, mpd_g, _, _ = disc.mpd(y, y_hat.detach(), cdt, fused=True)
            l_mpd, _, _ = discriminator_loss(mpd_r, mpd_g)
            msd_r, msd_g, _, _ = disc.msd(y, y_hat.detach(), cdt, fused=True)
            l_msd, _, _ = discriminator_loss(msd_r, msd_g)
            d_loss = l_mpd + l_msd
            d_grads = summed(_grads(d_loss * share, d_params), disc)
            with torch.no_grad():
                state["disc"]["opt_state"] = _apply(disc, d_grads, state["disc"]["opt_state"], disc_tx)
            del d_grads, mpd_r, mpd_g, msd_r, msd_g

            # the generator against the updated discriminators
            mel_l1 = torch.mean(torch.abs(_log_mel(y_hat, loss_cfg) - mel_target))
            mpd_r, mpd_g, fr_p, fg_p = disc.mpd(y, y_hat, cdt)
            msd_r, msd_g, fr_s, fg_s = disc.msd(y, y_hat, cdt)
            fm = feature_loss(fr_p, fg_p) + feature_loss(fr_s, fg_s)
            adv_p, _ = generator_loss(mpd_g)
            adv_s, _ = generator_loss(msd_g)
            g_loss = mel_l1 * mel_loss_weight + fm + adv_p + adv_s
            metrics = {"d_loss": d_loss, "d_mpd": l_mpd, "d_msd": l_msd, "mel_l1": mel_l1, "fm": fm,
                       "adv": adv_p + adv_s}
            if use_stft_loss:
                sc, mag = multi_resolution_stft_loss(y_hat, y)
                g_loss = g_loss + stft_loss_weight * (sc + mag)
                metrics.update(stft_sc=sc, stft_mag=mag)
            metrics["g_loss"] = g_loss
            g_grads = summed(_grads(g_loss * share, g_params), gen)
            with torch.no_grad():
                state["gen"]["opt_state"] = _apply(gen, g_grads, state["gen"]["opt_state"], gen_tx)
                if ema_decay is not None:
                    ema = list(state["ema"].parameters())
                    torch._foreach_mul_(ema, ema_decay)
                    torch._foreach_add_(ema, torch._foreach_mul(list(g_params.values()), 1.0 - ema_decay))
        state["step"] += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        if data_group is not None:
            metrics = all_reduce_tensors({k: v * share for k, v in metrics.items()}, data_group)
        return state, metrics

    # the filterbank of the generated audio's mel, the dataset's loss filterbank
    train_step.loss_mel_cfg = loss_cfg
    return train_step


def make_gan_eval_step(voc_cfg: HiFiGANConfig, mel_cfg: MelConfig = MelConfig(), fmax_loss: float | None = None,
                       mrf_impl: str = "kernel", device="cuda"):
    """eval_step(generator, batch) -> {"mel_l1", "wav"}: the mel-L1 of the
    generated audio's log-mel against `batch["mel_loss"]`, in f32. A
    `HiFiGANTrainGenerator` is folded first; an inference `HiFiGANGenerator`
    (a fold made once for several batches) is taken as it is. On the card its
    MRF stages run the f32 kernel; `mrf_impl="plain"` runs their plain version."""
    dev = resolve_device(device)
    loss_cfg = loss_mel_config(mel_cfg, fmax_loss)

    def eval_step(generator, batch):
        voc = generator.fold() if isinstance(generator, HiFiGANTrainGenerator) else generator
        if not isinstance(voc, HiFiGANGenerator) or voc.cfg != voc_cfg:
            raise TypeError(f"eval_step takes a generator of {voc_cfg}")
        check_module_device(voc, dev)
        batch = batch_to_device(batch, dev)
        with full_f32(), torch.no_grad():
            wav = voc(batch["mel"], mrf_impl=mrf_impl)
            mel_l1 = torch.mean(torch.abs(_log_mel(wav, loss_cfg) - batch["mel_loss"]))
        return {"mel_l1": mel_l1, "wav": wav}

    eval_step.loss_mel_cfg = loss_cfg
    return eval_step

