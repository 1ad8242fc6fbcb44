"""Open-loop serving: Poisson arrivals into `DynamicBatcher.submit` -> `TTSEngine`, as `bin/serve.py` wraps them.

Each request is one sentence, its size from the corpus's duration
quantiles and its gap to the next from an exponential's quantiles at the
traffic's `rate`, both in the plan's fixed order; the words come from the
run seed. One thread sends each request at its due time; a request's
latency runs from when it was due (not from when it was sent, so a late
generator counts against it) to when its waveform is on the host. A
request that is shed, fails, or has not come back `drain_s` after the
window closed counts as never completing: its latency is the time from its
due time to the end of that wait.

The engine serves at its defaults (`max_batch`, PCM16 transfer, the fetch
one batch late), the batcher with the traffic's wait, queue and deadline.
To judge each answer, the driver notes which requests the batcher put in
one micro-batch (by wrapping the engine's `_fetch_batch`): the reference
pads a request's text as its batch was padded and decodes at the bucket
that the batch's reference lengths pick.
"""

from __future__ import annotations

import concurrent.futures
import gc
import threading
import time

import numpy as np
import torch

from port_bench import corpus, program, weights
from port_bench.reference import efts as ref_efts
from port_bench.reference import hifigan as ref_hifigan
from port_bench.reference.text import encode

PCM_SCALE = 32767.0


class Session:
    def __init__(self, cell):
        from efficient_tts_tpu_torch.serve import TTSEngine

        self.cell, self.device = cell, torch.device(cell.device)
        cfg, tr = cell.config, cell.traffic
        self.hop = cfg["vocoder_params"]["hop_size"]
        n = tr["pool"]
        self.gaps = corpus.planned(corpus.exponential_quantiles(n, 1.0 / tr["rate"]), tr["plan_seed"])
        seconds = corpus.planned(corpus.beta_quantiles(n), tr["plan_seed"] + 1)
        chars = np.maximum(np.round(corpus.frames(seconds) / cfg["pinned_frames_per_symbol"]), 2).astype(int)
        rng = np.random.default_rng(weights.sub_seed(cell.seed, "text"))
        self.texts = [corpus.sentence(rng, int(c)) for c in chars]
        self.trees = program.inference_trees(cfg, cell.seed, self.device)
        model, voc = program.inference_models(cfg, self.trees, self.device)
        self.engine = TTSEngine(model, voc, device=self.device, max_batch=tr["max_batch"])
        self.t1_multiple, self.t2_multiple = self.engine.t1_multiple, self.engine.t2_multiple
        self.max_t1, self.max_t2 = self.engine.max_t1, self.engine.max_t2
        self._batch_of: dict[int, int] = {}  # id(waveform) -> micro-batch number
        self._n_batches = 0
        self._lock = threading.Lock()
        fetch = self.engine._fetch_batch

        def noted_fetch(handle):
            wavs = fetch(handle)
            with self._lock:
                for w in wavs:
                    self._batch_of[id(w)] = self._n_batches
                self._n_batches += 1
            return wavs

        self.engine._fetch_batch = noted_fetch
        t1s = sorted({ref_efts.bucket(len(t), self.t1_multiple) for t in self.texts})
        self.engine.warmup(t1_lengths=t1s)
        # a stretch of the traffic itself, for the mixes of lengths a batch reaches
        self._run(tr["warm_seconds"], start=n // 2, keep=False)
        self.engine.reset_stats()

    def _batcher(self):
        from efficient_tts_tpu_torch.serve import DynamicBatcher

        tr = self.cell.traffic
        return DynamicBatcher(self.engine, max_wait_ms=tr["max_wait_ms"], max_queue=tr["max_queue"],
                              deadline_ms=tr["deadline_ms"])

    def _run(self, seconds: float, start: int = 0, keep: bool = True) -> dict:
        """Send the requests due in `seconds` from plan index `start`; wait for
        each up to `drain_s` after the last is due. Returns their records."""
        from efficient_tts_tpu_torch.serve import AdmissionError

        n = len(self.texts)
        due = np.cumsum(np.roll(self.gaps, -start))
        due = due[due <= seconds]
        batcher = self._batcher()
        done = np.full(len(due), np.nan)
        sent = np.zeros(len(due))
        wavs: list = [None] * len(due)
        futures = []
        # a future wakes its waiters before it runs its callbacks: count the callbacks run
        called = threading.Condition()
        n_called = [0]

        def finished(i, fut):
            t = time.perf_counter()
            if fut.exception() is None:
                done[i] = t
                if keep:
                    wavs[i] = fut.result()
            with called:
                n_called[0] += 1
                called.notify_all()

        try:
            t0 = time.perf_counter()
            for i, d in enumerate(due):
                wait = t0 + d - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                sent[i] = time.perf_counter()
                try:
                    fut = batcher.submit(self.texts[(start + i) % n])
                except AdmissionError:
                    continue
                fut.add_done_callback(lambda f, i=i: finished(i, f))
                futures.append(fut)
            closed = t0 + (due[-1] if len(due) else 0.0)
            concurrent.futures.wait(futures, timeout=max(0.0, closed + self.cell.traffic["drain_s"] - time.perf_counter()))
            end = time.perf_counter()
            n_done = sum(f.done() for f in futures)
            with called:
                called.wait_for(lambda: n_called[0] >= n_done, timeout=10.0)
        finally:
            batcher.close()
        due_abs = t0 + due
        latency = np.where(np.isnan(done), end - due_abs, done - due_abs)
        return {"due": due_abs, "sent": sent, "latency": latency, "completed": ~np.isnan(done), "wavs": wavs,
                "start": start}

    def window(self, seconds: float) -> dict:
        with self._lock:
            self._batch_of.clear()
        self.engine.reset_stats()
        r = self._run(seconds)
        self.result = r
        stats = self.engine.stats
        lag = r["sent"] - r["due"]
        record = {"window_s": seconds, "lag_s": lag.tolist(), "batch_sizes": list(stats.batch_sizes),
                  "dispatch_s": stats.dispatch_seconds, "batches": stats.batches}
        n = len(r["latency"])
        p95 = float(np.percentile(r["latency"], 95)) if n else float("nan")
        return {"e2e": {"serve_p95_ms": 1e3 * p95}, "attempted": n, "failed": int(n - r["completed"].sum()),
                "record": record}

    def traced(self, seconds: float = 3.0) -> dict:
        from port_bench.record import profile

        start = len(self.texts) // 4
        return profile(lambda: self._run(seconds, start=start, keep=False))

    def release(self) -> None:
        del self.engine  # the wrapped fetch closes a cycle through it
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _chosen(self):
        """(chosen request indices, each completed request's micro-batch, the
        members of each micro-batch): a sample of the completed requests drawn
        from the seed, with the longest of them."""
        r = self.result
        ok = np.flatnonzero(r["completed"])
        batch = {int(i): self._batch_of[id(r["wavs"][i])] for i in ok}
        members: dict[int, list] = {}
        for i, b in batch.items():
            members.setdefault(b, []).append(i)
        rng = np.random.default_rng(weights.sub_seed(self.cell.seed, "check"))
        n = min(self.cell.traffic["check_requests"], len(ok))
        chosen = set(int(i) for i in rng.choice(ok, n, replace=False)) if n else set()
        if len(ok):
            chosen.add(int(ok[np.argmax([len(self._text(i)) for i in ok])]))
        return chosen, batch, members

    def _text(self, i: int) -> str:
        return self.texts[(self.result["start"] + i) % len(self.texts)]

    def reference(self, ops, chosen, batch, members) -> dict:
        """{request: its PCM16 waveform} of the reference at precision `ops`,
        each decoded with the micro-batch the batcher put it in."""
        mp, vp = self.cell.config["model_params"], self.cell.config["vocoder_params"]
        acoustic, vocoder = self.trees
        out = {}
        with torch.no_grad(), ops.precision(self.device):
            for b in sorted({batch[i] for i in chosen}):
                group = members[b]
                ids = [encode(self._text(i)) for i in group]
                lengths = torch.tensor([len(x) for x in ids], device=self.device)
                t1 = min(ref_efts.bucket(int(lengths.max()), self.t1_multiple), self.max_t1)
                text = torch.zeros((len(ids), t1), dtype=torch.long, device=self.device)
                for j, x in enumerate(ids):
                    text[j, :len(x)] = torch.tensor(x, device=self.device)
                s1 = ref_efts.cnn_stage1(acoustic, mp, text, lengths, ops)
                t2 = min(ref_efts.bucket(int(s1["lengths"].max()), self.t2_multiple), self.max_t2)
                rows = [j for j, i in enumerate(group) if i in chosen]
                mel, mel_lengths = ref_efts.cnn_decode(acoustic, mp, s1, rows, t2, ops)
                wav = ref_hifigan.generator(vocoder, vp, mel, ops)
                for j, row in enumerate(rows):
                    w = wav[j, :int(mel_lengths[j]) * self.hop]
                    out[group[row]] = torch.round(torch.clamp(w, -1.0, 1.0) * PCM_SCALE).cpu().numpy()
        return out

    def substitute(self, ops) -> None:
        """Put the reference at `ops` in the program's place for the sampled requests."""
        chosen, batch, members = self._chosen()
        for i, pcm in self.reference(ops, chosen, batch, members).items():
            w = (pcm / PCM_SCALE).astype(np.float32)
            self._batch_of[id(w)] = batch[i]
            self.result["wavs"][i] = w

    def check(self, ops) -> dict:
        """lost: requests due in the window that never came back; len_mismatch:
        sampled answers whose length is not the reference's mel length times
        the hop; pcm_far: their samples more than one PCM16 step (1 / 32767)
        from the reference's, quantized as the engine quantizes (any such
        sample is wrong: both sides differ by rounding only where a value
        sits near a step's edge); pcm_mismatch_share: the share of their
        samples whose PCM16 value differs from the reference's at all."""
        chosen, batch, members = self._chosen()
        ref = self.reference(ops, chosen, batch, members)
        mismatch, far, differ, total = 0, 0, 0, 0
        for i, want in ref.items():
            got = np.round(self.result["wavs"][i] * PCM_SCALE)
            if got.shape != want.shape:
                mismatch += 1
                continue
            gap = np.abs(got - want)
            far += int(np.sum(gap > 1))
            differ += int(np.sum(gap > 0))
            total += gap.size
        lost = len(self.result["latency"]) - int(self.result["completed"].sum())
        return {"lost": float(lost), "len_mismatch": float(mismatch), "pcm_far": float(far),
                "pcm_mismatch_share": differ / max(total, 1)}
