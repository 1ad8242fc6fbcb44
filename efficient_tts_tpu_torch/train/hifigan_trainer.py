"""Step-based trainer of the HiFi-GAN vocoder (counterpart of `efficient_tts_tpu/train/hifigan_trainer.py`).

Runs a GAN `train_step` (`train/hifigan_train_step.py`) until
`train_max_steps` over any iterator of (epoch, batch) pairs, in
`EftsTrainer`'s shape:
  * a step's metrics are packed into one device vector (keys sorted) and
    read back one step late, after the next step has been queued;
  * a non-finite g_loss or d_loss saves the state as `diverged-state-{step}`
    (invisible to `latest_checkpoint`; one or two updates past the
    divergence, so resume from an interval checkpoint instead) and raises
    FloatingPointError;
  * interval logs (means over the interval), evals of the EMA generator when
    tracked (else the raw one; folded once per eval for the inference
    generator, whose MRF stages run the card's f32 kernel) and saves, with
    `max_keep_checkpoints`; SIGTERM and Ctrl-C save before leaving `run`;
  * the interval saves write in the background (`save(wait=False)`); the
    divergence dump, the SIGTERM and Ctrl-C save, pruning and every `load`
    wait for the write;
  * `step_times` (each step's epoch, wall time and data wait), `metrics_log`
    and `eval_log` keep their last `HISTORY` entries.
`load` reconciles the EMA as the JAX trainer does: a checkpoint with an EMA
that this run does not track drops it with a warning, and a checkpoint
without one seeds the tracked EMA from the restored generator; one without
discriminators keeps the state's. Checkpoints
are `train/checkpoint.py`'s; the JAX package's orbax directories are not
read.

With a `mesh` (JAX :48, :164-176; a `shard_gan_state` state and a
`make_gan_train_step(mesh=)` step, one process per rank), as `EftsTrainer`
does: `save` gathers the one-card state and rank 0 alone writes it
(collective), `load` reads that file on every rank and keeps the rank's
slices, the logs and the writer are the primary rank's, and each eval
gathers the generator (collective) and runs on rank 0 alone.
"""

from __future__ import annotations

import logging
import math
import os
import time
from collections import defaultdict, deque

import torch

from efficient_tts_tpu_torch.parallel.distributed import is_primary
from efficient_tts_tpu_torch.parallel.sharding import gather_state_dict, slice_saved
from efficient_tts_tpu_torch.train import checkpoint as ckpt
from efficient_tts_tpu_torch.models.hifigan_train import HiFiGANTrainGenerator
from efficient_tts_tpu_torch.train.hifigan_train_step import ema_generator
from efficient_tts_tpu_torch.utils.device import resolve_device
from efficient_tts_tpu_torch.utils.preemption import convert_sigterm

log = logging.getLogger(__name__)


class HiFiGANTrainer:
    HISTORY = 1000  # entries kept in step_times, metrics_log and eval_log

    def __init__(self, train_step, state, train_iter, outdir: str = "exp_vocoder", train_max_steps: int = 400_000,
                 save_interval_steps: int = 5000, log_interval_steps: int = 100, writer=None, eval_step=None,
                 eval_batches=None, eval_interval_steps: int = 1000, max_keep_checkpoints: int | None = None,
                 device="cuda", mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.primary = is_primary()
        self.train_step = train_step
        self.state = state
        self.train_iter = train_iter
        self.outdir = outdir
        self.train_max_steps = train_max_steps
        self.save_interval_steps = save_interval_steps
        self.log_interval_steps = log_interval_steps
        self.writer = writer if self.primary else None
        self.eval_step = eval_step
        self.eval_batches = eval_batches or []
        self.eval_interval_steps = eval_interval_steps
        self.max_keep_checkpoints = max_keep_checkpoints
        self.step_times: deque[dict] = deque(maxlen=self.HISTORY)
        self.metrics_log: deque[dict] = deque(maxlen=self.HISTORY)
        self.eval_log: deque[dict] = deque(maxlen=self.HISTORY)
        self.saved_step = None  # the step of the last `checkpoint-{step}steps` written
        os.makedirs(outdir, exist_ok=True)

    def save(self, wait: bool = False, name: str | None = None) -> str:
        """Write the state (under a mesh: gathered, by rank 0; collective) and
        return the checkpoint's path. The host snapshot is taken before this
        returns; without `wait` the disk write goes on in the background
        (`train/checkpoint.py`), as the interval saves do. Pruning
        (`max_keep_checkpoints`) waits for it."""
        path = ckpt.save_train_state(self.outdir, self.state, name, self.mesh, self.max_keep_checkpoints, wait)
        if name is None:
            self.saved_step = self.state["step"]
        if self.primary:
            log.info("saved vocoder checkpoint %s%s", path, "" if wait else " (writing in the background)")
        return path

    def load(self, path: str) -> None:
        """Resume from `path`, reconciling the optional EMA generator. A
        checkpoint without discriminators (a reference generator converted by
        `bin/convert_checkpoint.py`) leaves them and their optimizer state as
        they are: the seeded init."""
        ckpt.settle(self.mesh)
        saved = ckpt.read_checkpoint(path, ckpt.state_device(self.state))
        tracking, on_disk = "ema" in self.state, "ema" in saved
        if on_disk and not tracking:
            log.warning("checkpoint carries an EMA generator but --ema_decay is unset: the saved EMA will be "
                        "dropped and not carried forward (pass --ema_decay to keep tracking it)")
            saved.pop("ema")
        elif tracking and not on_disk:
            log.warning("checkpoint predates EMA tracking; seeding the EMA from the restored generator params")
            saved["ema"] = saved["gen"]["params"]
        if "disc" not in saved:
            log.warning("%s holds no discriminators: they start from their seeded init", path)
        if self.mesh is not None:
            saved = slice_saved(saved, self.state, self.mesh)
        self.state.update(ckpt.restore({k: v for k, v in self.state.items() if k in saved}, saved))

    def run(self):
        """Train until `train_max_steps`; SIGTERM and Ctrl-C checkpoint first."""
        with convert_sigterm():
            return self._run()

    def _run(self):
        keys = None
        totals = defaultdict(float)
        count = 0
        wait = 0.0
        t_last = time.time()
        step = self.state["step"]
        pending = None  # (step, epoch, packed metrics) awaiting the host readback

        def consume(p):
            nonlocal count, wait, t_last
            pstep, pepoch, packed = p
            vals = dict(zip(keys, packed.tolist()))
            count += 1
            self.metrics_log.append({"step": pstep, **vals})
            for k in ("g_loss", "d_loss"):
                if not math.isfinite(vals[k]):
                    log.error("non-finite %s=%r at step %d: saving the state and stopping; resume from the last "
                              "interval checkpoint, not this one (it is 1-2 updates past the divergence)",
                              k, vals[k], pstep)
                    self.save(wait=True, name=f"diverged-state-{pstep}")
                    raise FloatingPointError(f"GAN training diverged: {k}={vals[k]} at step {pstep}")
            for k, v in vals.items():
                totals[k] += v
            if pstep % self.log_interval_steps == 0:
                dt = time.time() - t_last
                means = {k: v / count for k, v in totals.items()}
                (log.info if self.primary else log.debug)(
                    "step %d (epoch %d): g=%.3f d=%.3f mel_l1=%.3f (%.2f steps/s, data wait %.1f ms a step)",
                    pstep, pepoch, means["g_loss"], means["d_loss"], means["mel_l1"], count / max(dt, 1e-9),
                    1e3 * wait / count)
                if self.writer is not None:
                    for k, v in means.items():
                        self.writer.add_scalar(f"vocoder/{k}", v, pstep)
                totals.clear()
                count = 0
                wait = 0.0
                t_last = time.time()

        try:
            while step < self.train_max_steps:
                t_iter = time.perf_counter()
                epoch, batch = next(self.train_iter)
                t_data = time.perf_counter()
                self.state, metrics = self.train_step(self.state, batch)
                step = self.state["step"]
                if keys is None:
                    keys = tuple(sorted(metrics))
                packed = torch.stack([metrics[k] for k in keys])
                if pending is not None:
                    consume(pending)
                pending = (step, epoch, packed)
                wait += t_data - t_iter
                self.step_times.append({"step": step, "epoch": epoch, "wall_s": time.perf_counter() - t_iter,
                                        "data_wait_s": t_data - t_iter})
                if self.eval_step is not None and self.eval_batches and step % self.eval_interval_steps == 0:
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

    def evaluate(self, step: int) -> float | None:
        """The mean mel-L1 over the eval batches of the EMA generator (the raw
        one when no EMA is tracked), folded once. Under a mesh the generator is
        gathered (collective) and rank 0 alone evaluates; the others return
        None."""
        gen = ema_generator(self.state)
        if self.mesh is not None:
            whole = gather_state_dict(gen, self.mesh)
            if not self.primary:
                return None
            gen = HiFiGANTrainGenerator(gen.cfg).to(self.device)
            gen.load_state_dict(whole)
        voc = gen.fold()
        total = 0.0
        for batch in self.eval_batches:
            total += float(self.eval_step(voc, batch)["mel_l1"])
        mel_l1 = total / max(len(self.eval_batches), 1)
        log.info("eval step %d: mel_l1=%.4f", step, mel_l1)
        self.eval_log.append({"step": step, "mel_l1": mel_l1})
        if self.writer is not None:
            self.writer.add_scalar("vocoder/eval_mel_l1", mel_l1, step)
        return mel_l1
