"""Train and eval steps of the acoustic models (counterpart of `efficient_tts_tpu/train/efts_train_step.py`).

`make_train_step(cfg, tx)` returns `train_step(state, batch, gen) ->
(state, metrics)`: the training forward of the model that the registry
gives for `cfg`, its gradients, and one optimizer update, under
`full_f32()` (cuBLAS and cuDNN without TF32, as the JAX reference computes
in f32). Dropout is on when `cfg.dropout_rate > 0`, driven by the CPU
generator `gen`. The metrics are device scalars: loss, mel_loss,
duration_loss and grad_norm, the global norm of the unclipped gradients.
The state is updated in place (`train/state.py`). While a torch profiler
runs, the spans `train.forward` (model and losses), `train.backward` and
`train.optimizer` (global norm, clip, update, with its device time) mark
a step's parts (`utils/profiling.py`).

`accum_steps > 1` splits the batch into micro-batches, run one after the
other with one resident micro-batch of activations at a time. Before its
backward, each micro-batch's mel and duration losses are weighted by its
share of the full batch's valid mel frames and text tokens (with
`use_masking`; its share of the rows without), so the summed gradient is
the full batch's, ragged lengths included, and one update follows.

Over ranks (`mesh=`, one process per rank, `parallel/`), as JAX's GSPMD
step computes it:
  * dp: each rank takes its block of rows of the global batch
    (`shard_batch`, or `data/loader.py:device_prefetch(mesh=)`) and weights
    its mel and duration losses by its share of the global count (valid
    frames and tokens with `use_masking`, padded elements without it, rows
    with `loss_normalize: utterance`), all-reduced over the data group
    before the backward; the gradients are then summed over the data group.
    With `accum_steps`, JAX cuts the global batch into micro-batches before
    it shards them: the rank holds its rows of each (`split_batch(...,
    accum_steps)`), weighted by its share of the micro-batch's global count
    times the micro-batch's weight, so every normalization gives JAX's step.
  * tp: the state holds `shard_state`'s column-parallel copy
    (`parallel/sharding.py:shard_module(trainable=True)`): a rank's sharded
    leaves are slices, the replicated ones whole (averaged over the model
    group, so the row's copies cannot drift: `agree_replicated`), and the
    global norm, computed once (`sharded_grad_norm`: the sharded leaves'
    squares summed over the model group), is both `grad_norm` and the norm
    the optimizer's clip takes. dp+tp composes both.
  * sp (`sequence_parallel=True`, either model): the model row splits the
    mel frames (`parallel/sequence_parallel.py`); the gradients are summed
    over the whole mesh. The EFTS-Transformer's self-attention over T2 takes
    its queries from the rank's frames and its keys and values from the
    whole sequence, gathered over the row.
The metrics are the global ones on every rank. The dropout generator is
the caller's: one per data row, equal across a model row
(`parallel/mesh.py:data_seed`).

Entry points run on `device` ("cuda" by default) and raise without a card
unless the caller passes device="cpu".
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from efficient_tts_tpu_torch.models import model_class_for
from efficient_tts_tpu_torch.parallel.distributed import all_reduce_tensors, rank_device
from efficient_tts_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
from efficient_tts_tpu_torch.parallel.sequence_parallel import SeqShard
from efficient_tts_tpu_torch.parallel.sharding import (agree_replicated, shard_module, sharded_grad_norm, sharded_names,
                                                       split_batch)
from efficient_tts_tpu_torch.train.optim import global_norm
from efficient_tts_tpu_torch.train.state import apply_updates, create_state, named_params
from efficient_tts_tpu_torch.utils.device import check_module_device, resolve_device
from efficient_tts_tpu_torch.utils.precision import full_f32
from efficient_tts_tpu_torch.utils.profiling import span

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


def loss_counts(cfg, batch: dict) -> torch.Tensor:
    """[mel, duration] counts that weight a block's losses into those of the
    batch it is part of, by the losses' own normalization: the valid frames
    and tokens with `use_masking` (the rows that hold a token with
    `loss_normalize: utterance`), the rows without it (the padded elements,
    every block being padded alike)."""
    tl = batch["text_lengths"]
    if not cfg.use_masking:
        rows = torch.tensor(float(tl.shape[0]), device=tl.device)
        return torch.stack([rows, rows])
    if cfg.loss_normalize == "utterance":
        rows = (tl > 0).sum().float()
        return torch.stack([rows, rows])
    return torch.stack([batch["mel_lengths"].sum(), tl.sum()]).float()


def micro_counts(cfg, batch: dict) -> torch.Tensor:
    """[mel, duration] counts by which JAX weights a micro-batch: its valid
    frames and tokens with `use_masking`, under every normalization; 1
    without it."""
    if not cfg.use_masking:
        return torch.ones(2, device=batch["text_lengths"].device)
    return torch.stack([batch["mel_lengths"].sum(), batch["text_lengths"].sum()]).float()


def _groups(mesh, sequence_parallel: bool):
    """(data group or None, the group gradients and metrics sum over or None,
    SeqShard or None) of a mesh; extents of 1 need no collective."""
    if mesh is None:
        return None, None, None
    d, m = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
    sp = SeqShard(mesh) if sequence_parallel and m > 1 else None
    data_group = mesh.data_group if d > 1 else None
    return data_group, (mesh.group if sp is not None else data_group), sp


def make_train_step(cfg, tx, mesh=None, sequence_parallel: bool = False, accum_steps: int = 1, device="cuda"):
    dev = resolve_device(device)
    model_cls = model_class_for(cfg, training=True)
    deterministic = cfg.dropout_rate <= 0.0
    if sequence_parallel and mesh is None:
        raise ValueError("sequence_parallel requires a mesh")
    data_group, reduce_group, sp = _groups(mesh, sequence_parallel)

    def grads_and_metrics(model, params, batch, gen, w_mel=1.0, w_dur=1.0):
        mel = batch["mel"]
        kw = {}
        if sp is not None:
            mel, kw = mel[:, sp.frames(mel.shape[1])], {"sp": sp}
        with span("train.forward"):
            out = model(batch["text"], batch["text_lengths"], mel, batch["mel_lengths"], gen=gen,
                        deterministic=deterministic, **kw)
            mel, dur = w_mel * out["mel_loss"], w_dur * out["duration_loss"]
            loss = mel + dur
        with span("train.backward"):
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            grads = {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(params.items(), grads)}
        return grads, {"loss": loss.detach(), "mel_loss": mel.detach(), "duration_loss": dur.detach()}

    def train_step(state, batch, gen=None):
        """One update on `batch`: the whole batch, or under a mesh this
        rank's block of rows of the global batch."""
        model = _checked_model(state["params"], model_cls, dev)
        if not deterministic and gen is None:
            raise ValueError(f"dropout_rate={cfg.dropout_rate} trains with dropout: pass a CPU generator")
        batch = batch_to_device(batch, dev)
        params = named_params(model)
        with full_f32():
            if accum_steps <= 1 and data_group is None:
                grads, metrics = grads_and_metrics(model, params, batch, gen)
            else:
                grads, metrics = _accumulate(model, params, batch, gen)
            if reduce_group is not None:
                grads, metrics = all_reduce_tensors(grads, reduce_group), all_reduce_tensors(metrics, reduce_group)
            with span("train.optimizer", device=True):
                sharded = sharded_names(model)
                if sharded:
                    grads = agree_replicated(grads, sharded, mesh)
                    metrics["grad_norm"] = sharded_grad_norm(grads, sharded, mesh.model_group)
                else:
                    metrics["grad_norm"] = global_norm(list(grads.values()))
                apply_updates(state, grads, tx, metrics["grad_norm"])
        return state, metrics

    def _accumulate(model, params, batch, gen):
        b = batch["text"].shape[0]
        if b % accum_steps:
            raise ValueError(f"batch dim {b} not divisible by accum_steps={accum_steps}")
        n = b // accum_steps
        micro = [{k: v[i * n:(i + 1) * n] for k, v in batch.items()} for i in range(accum_steps)]
        # Under dp the rank's micro-batch i is its rows of the global
        # micro-batch i (`split_batch(accum_steps=)`). Its weight is its share
        # of that micro-batch's count by the losses' normalization, times the
        # micro-batch's weight in the batch, as JAX weights micro-batches.
        own = torch.stack([loss_counts(cfg, m) for m in micro])
        counts = torch.cat([own, torch.stack([micro_counts(cfg, m) for m in micro])], dim=1)
        if data_group is not None:
            dist.all_reduce(counts, group=data_group)
        whole, by_micro = counts[:, :2], counts[:, 2:]
        w = own / torch.clamp(whole, min=1.0) * (by_micro / torch.clamp(by_micro.sum(dim=0), min=1.0))
        grads, metrics = None, None
        for i, mb in enumerate(micro):
            g, m = grads_and_metrics(model, params, mb, gen, w[i, 0], w[i, 1])
            if grads is None:
                grads, metrics = g, m
            else:
                grads = {n: grads[n] + g[n] for n in grads}
                metrics = {k: metrics[k] + m[k] for k in metrics}
        return grads, metrics

    return train_step


def make_eval_step(cfg, mesh=None, device="cuda"):
    """eval_step(model, batch) -> {loss, mel_loss, duration_loss, imv,
    reconst_alpha, mel_pred}: the training forward without dropout or
    gradients. Under a mesh `batch` is this rank's block of the eval batch:
    the losses are the global ones (weighted as the train step weights
    them), the rest the block's."""
    dev = resolve_device(device)
    model_cls = model_class_for(cfg, training=True)
    data_group, _, _ = _groups(mesh, False)

    def eval_step(model, batch):
        model = _checked_model(model, model_cls, dev)
        batch = batch_to_device(batch, dev)
        with full_f32(), torch.no_grad():
            out = model(batch["text"], batch["text_lengths"], batch["mel"], batch["mel_lengths"],
                        deterministic=True)
            if data_group is not None:
                counts = loss_counts(cfg, batch)
                total = counts.clone()
                dist.all_reduce(total, group=data_group)
                w = counts / torch.clamp(total, min=1.0)
                mel, dur = w[0] * out["mel_loss"], w[1] * out["duration_loss"]
                out.update(all_reduce_tensors({"loss": mel + dur, "mel_loss": mel, "duration_loss": dur},
                                              data_group))
        return {k: out[k] for k in (*METRIC_KEYS, "imv", "reconst_alpha", "mel_pred")}

    return eval_step


def shard_state(model, tx, mesh, sequence_parallel: bool = False, device="cuda") -> dict:
    """The train state of this rank on `mesh` (JAX :203-219): under tp the
    trainable column-parallel copy of `model` (`shard_module`), whose
    optimizer moments are made from the rank's slices; `model` itself is
    left whole. Under dp or sp (`sequence_parallel`) every rank holds the
    whole model."""
    check_module_device(model, resolve_device(device))
    if mesh.shape[MODEL_AXIS] > 1 and not sequence_parallel:
        model = shard_module(model, mesh, trainable=True)
    return create_state(model, tx)


def shard_batch(batch: dict, mesh, accum_steps: int = 1, device="cuda") -> dict:
    """This rank's rows of a global batch (JAX's `shard_batch`; with
    `accum_steps`, its rows of each micro-batch: `split_batch`), as tensors
    on its card (`parallel/distributed.py:rank_device`)."""
    return batch_to_device({k: split_batch(batch[k], mesh, accum_steps) for k in BATCH_DTYPES}, rank_device(device))
