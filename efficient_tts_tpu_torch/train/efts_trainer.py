"""Step-based trainer of the acoustic models (counterpart of `efficient_tts_tpu/train/efts_trainer.py:EftsTrainer`).

Runs `train_step` until `train_max_steps` over any iterator of (epoch,
batch) pairs, with interval logging (means over the interval), interval
eval and interval saves:
  * the metrics of a step are packed into one device vector and read back
    one step late, after the next step has been queued, so the readback
    does not leave the card idle;
  * a non-finite loss saves the state as `diverged-state-{step}` (invisible
    to `latest_checkpoint`) and raises FloatingPointError; the metrics are
    read one step late, so that state is one or two updates past the step;
  * the interval saves return once the state is copied to host memory and
    write in the background (`save(wait=False)`, as JAX's orbax saves); the
    divergence dump, the SIGTERM and Ctrl-C save (made before the exception
    leaves `run`), pruning and every `load` wait for the write;
  * `step_times` keeps, for each step, its epoch, its wall time from the
    request for the batch to the readback of the step before (evals and
    saves left out) and the part of it spent waiting on the batch iterator;
    the log line gives the interval's mean wait. `metrics_log` keeps each
    step's losses as read back, `eval_log` each eval's means. The three
    keep the last `HISTORY` entries only.
Batches may come as numpy arrays or as tensors already on the device
(`data/loader.py:device_prefetch`), which the step takes without a copy.
Each eval draws the JAX trainer's diagnostics from its first batch
(`_plot_diagnostics`: `outdir/images/step{N}_{i}_{imv,align,mel}.png` for
up to 4 utterances); where matplotlib is not installed it logs one warning
per trainer and draws nothing, the evals running on. Entry points run on
`device` ("cuda" by default) and raise without a card unless the caller
passes device="cpu".

With a `mesh` (JAX :49, :79-83, :152-161, :213-219; one process per rank):
`init_state` shards (`train/efts_train_step.py:shard_state`); the train
iterator yields this rank's rows of each global batch
(`data/loader.py:device_prefetch(mesh=, accum_steps=)`); `save` is
collective: it gathers the one-card state (`parallel/sharding.py:
gather_train_state`) and rank 0 alone writes it, so a checkpoint is the
one-card file and resumes on any mesh; `load` reads that file on every rank
and keeps the rank's slices. Each eval batch is split over the data extent
and its losses weighted globally; the logs, the writer and the eval images
are the primary rank's. The metrics are all-reduced, so the divergence
guard stops every rank at the same step, and its forensic save is
collective. The dropout generator is seeded per data row
(`parallel/mesh.py:data_seed`).
"""

from __future__ import annotations

import logging
import math
import os
import time
from collections import defaultdict, deque

import numpy as np
import torch

from efficient_tts_tpu_torch.parallel.distributed import is_primary
from efficient_tts_tpu_torch.parallel.mesh import data_seed
from efficient_tts_tpu_torch.parallel.sharding import slice_saved, split_batch
from efficient_tts_tpu_torch.train import checkpoint as ckpt
from efficient_tts_tpu_torch.train.efts_train_step import (BATCH_DTYPES, METRIC_KEYS, make_eval_step,
                                                           make_train_step, shard_state)
from efficient_tts_tpu_torch.train.state import create_state
from efficient_tts_tpu_torch.utils.device import check_module_device, resolve_device
from efficient_tts_tpu_torch.utils.preemption import convert_sigterm

log = logging.getLogger(__name__)


class EftsTrainer:
    HISTORY = 1000  # entries kept in step_times, metrics_log and eval_log

    def __init__(self, cfg, tx, train_iter, eval_batches=None, outdir: str = "exp",
                 train_max_steps: int = 1_000_000, save_interval_steps: int = 5000,
                 eval_interval_steps: int = 1000, log_interval_steps: int = 1000, seed: int = 0,
                 writer=None, max_keep_checkpoints: int | None = None, accum_steps: int = 1,
                 device="cuda", mesh=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tx = tx
        self.train_iter = train_iter
        self.eval_batches = eval_batches or []
        self.outdir = outdir
        self.train_max_steps = train_max_steps
        self.save_interval_steps = save_interval_steps
        self.eval_interval_steps = eval_interval_steps
        self.log_interval_steps = log_interval_steps
        self.mesh = mesh
        self.primary = is_primary()
        self.writer = writer if self.primary else None
        self.gen = torch.Generator().manual_seed(data_seed(seed, mesh))  # the host-side dropout key
        self.max_keep_checkpoints = max_keep_checkpoints
        self.state = None
        self.step_times: deque[dict] = deque(maxlen=self.HISTORY)
        self.metrics_log: deque[dict] = deque(maxlen=self.HISTORY)
        self.eval_log: deque[dict] = deque(maxlen=self.HISTORY)
        self._train_step = make_train_step(cfg, tx, mesh=mesh, accum_steps=accum_steps, device=self.device)
        self._eval_step = make_eval_step(cfg, mesh=mesh, device=self.device)
        self._plots_warned = False
        os.makedirs(outdir, exist_ok=True)

    # -- state ------------------------------------------------------------

    def init_state(self, model):
        check_module_device(model, self.device)
        self.state = (create_state(model, self.tx) if self.mesh is None else
                      shard_state(model, self.tx, self.mesh, device=self.device))

    def save(self, wait: bool = False, name: str | None = None) -> str:
        """Write the state (under a mesh: gathered, by rank 0; collective) and
        return the checkpoint's path. The host snapshot is taken before this
        returns; without `wait` the disk write goes on in the background
        (`train/checkpoint.py`), as the interval saves do. Pruning
        (`max_keep_checkpoints`) waits for it."""
        path = ckpt.save_train_state(self.outdir, self.state, name, self.mesh, self.max_keep_checkpoints, wait)
        if self.primary:
            log.info("saved checkpoint %s%s", path, "" if wait else " (writing in the background)")
        return path

    def load(self, path, load_only_params: bool = False):
        ckpt.settle(self.mesh)
        saved = ckpt.read_checkpoint(path, ckpt.state_device(self.state))
        if self.mesh is not None:
            saved = slice_saved(saved, self.state, self.mesh)
        self.state = ckpt.restore(self.state, saved, load_only_params)

    # -- loop -------------------------------------------------------------

    def run(self):
        """Train until `train_max_steps`; SIGTERM and Ctrl-C checkpoint first."""
        with convert_sigterm():
            return self._run()

    def _run(self):
        if self.state is None:
            raise RuntimeError("call init_state first")
        totals = defaultdict(float)
        count = 0
        wait = 0.0  # the interval's data wait, seconds
        t_last = time.time()
        step = self.state["step"]
        pending = None  # (step, epoch, packed metrics) awaiting the host readback

        def consume(p):
            nonlocal count, wait, t_last
            pstep, pepoch, packed = p
            vals = packed.tolist()
            count += 1
            self.metrics_log.append({"step": pstep, **dict(zip(METRIC_KEYS, vals))})
            self._check_finite(vals[0], pstep)
            for k, v in zip(METRIC_KEYS, vals):
                totals[k] += v
            if pstep % self.log_interval_steps == 0:
                dt = time.time() - t_last
                means = {k: v / max(count, 1) for k, v in totals.items()}
                (log.info if self.primary else log.debug)(
                    "step %d (epoch %d): loss=%.4f mel=%.4f dur=%.4f (%.2f steps/s, data wait %.1f ms a step)",
                    pstep, pepoch, means["loss"], means["mel_loss"], means["duration_loss"],
                    count / max(dt, 1e-9), 1e3 * wait / count)
                if self.writer is not None:
                    for k, v in means.items():
                        self.writer.add_scalar(f"train/{k}", v, pstep)
                totals.clear()
                count = 0
                wait = 0.0
                t_last = time.time()

        try:
            while step < self.train_max_steps:
                t_iter = time.perf_counter()
                epoch, batch = next(self.train_iter)
                t_data = time.perf_counter()
                self.state, metrics = self._train_step(self.state, batch, self.gen)
                step = self.state["step"]
                packed = torch.stack([metrics[k] for k in METRIC_KEYS])
                if pending is not None:
                    consume(pending)
                pending = (step, epoch, packed)
                wait += t_data - t_iter
                self.step_times.append({"step": step, "epoch": epoch, "wall_s": time.perf_counter() - t_iter,
                                        "data_wait_s": t_data - t_iter})
                if self.eval_batches and step % self.eval_interval_steps == 0:
                    self.evaluate(step)
                if step % self.save_interval_steps == 0:
                    self.save()
            if pending is not None:
                consume(pending)
                pending = None
        except KeyboardInterrupt:
            self.save(wait=True)
            raise
        return self.state

    def _check_finite(self, loss_val: float, step: int):
        if math.isfinite(loss_val):
            return
        log.error("non-finite loss %r at step %d: saving the state and stopping", loss_val, step)
        self.save(wait=True, name=f"diverged-state-{step}")
        raise FloatingPointError(f"training diverged: loss={loss_val} at step {step}")

    def evaluate(self, step: int) -> dict:
        """Mean eval metrics, and the alignment's mean per-frame peak over the
        first batch's first 4 utterances (about 1/T1 when it collapsed)."""
        totals = defaultdict(float)
        peak = first = first_batch = None
        for batch in self.eval_batches:
            if self.mesh is not None:
                batch = {k: split_batch(np.asarray(batch[k]), self.mesh) for k in BATCH_DTYPES}
            out = self._eval_step(self.state["params"], batch)
            if first is None:
                # the first 4 utterances' diagnostics, read back once
                first = {k: out[k][:4].cpu().numpy() for k in ("imv", "reconst_alpha", "mel_pred")}
                first_batch = batch
                a = first["reconst_alpha"]
                tl, ml = np.asarray(batch["text_lengths"]), np.asarray(batch["mel_lengths"])
                peak = float(np.mean([a[i, :tl[i], :ml[i]].max(axis=0).mean() for i in range(a.shape[0])]))
                if peak < 2.5 / max(float(tl.max()), 1.0):
                    log.warning("alignment looks collapsed (mean peak %.4f, uniform 1/T1 = %.4f)", peak,
                                1.0 / max(float(tl.max()), 1.0))
            for k in METRIC_KEYS:
                totals[k] += float(out[k])
        means = {k: v / max(len(self.eval_batches), 1) for k, v in totals.items()}
        if peak is not None:
            means["align_peak"] = peak
        self.eval_log.append({"step": step, **means})
        if not self.primary:
            return means
        log.info("eval step %d: %s", step, " ".join(f"{k}={v:.4f}" for k, v in means.items()))
        if self.writer is not None:
            for k, v in means.items():
                self.writer.add_scalar(f"eval/{k}", v, step)
        if first is not None:
            self._plot_diagnostics(step, first, first_batch)
        return means

    def _plot_diagnostics(self, step: int, out: dict, batch: dict, max_items: int = 4) -> None:
        """The JAX trainer's eval images of up to `max_items` utterances: the
        IMV curve, the reconstructed alignment and the predicted mel beside the
        target, each cut to the utterance's lengths. Without matplotlib: one
        warning per trainer, no images."""
        from efficient_tts_tpu_torch.utils import plotting

        if not plotting.available():
            if not self._plots_warned:
                log.warning("matplotlib is not installed: the eval diagnostics (%s/images) are not drawn",
                            self.outdir)
                self._plots_warned = True
            return
        imgdir = os.path.join(self.outdir, "images")
        n = min(max_items, out["imv"].shape[0])
        target = batch["mel"][:n]
        target = target.cpu().numpy() if isinstance(target, torch.Tensor) else np.asarray(target)
        for i in range(n):
            t1, t2 = int(batch["text_lengths"][i]), int(batch["mel_lengths"][i])
            plotting.save_imv_plot(out["imv"][i][:t2], os.path.join(imgdir, f"step{step}_{i}_imv.png"))
            plotting.save_alignment_plot(out["reconst_alpha"][i][:t1, :t2],
                                         os.path.join(imgdir, f"step{step}_{i}_align.png"))
            plotting.save_mel_comparison(out["mel_pred"][i][:t2], target[i][:t2],
                                         os.path.join(imgdir, f"step{step}_{i}_mel.png"))
