"""Offline batched synthesis: `pipeline.synthesize_dispatch` + `fetch`, batch k + 1 dispatched before k is fetched.

The path of `bin/inference.py` and of batch jobs. A plan of `batches`
batches of `batch` utterances, sizes from the corpus's duration quantiles
in the plan's fixed order, is cycled through the window; each sentence has
the characters that `pinned_frames_per_symbol` turns into its duration, its
words drawn from the run seed. Text is padded to the batch's longest (as
the inference CLI pads it), the mel bucket is the program's own choice.

What the window produces and the check compares: the waveform lengths of
every batch fetched (from stage 1's readback), and the waveforms of a
sample of rows drawn from the seed, the plan's longest among them, each
against the reference run on its batch's padded text at the bucket that
the reference's own lengths pick.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench import corpus, program, weights
from port_bench.reference import efts as ref_efts
from port_bench.reference import hifigan as ref_hifigan
from port_bench.reference.text import encode
from port_bench.work import flops, roofline


class Session:
    def __init__(self, cell):
        from efficient_tts_tpu_torch import pipeline

        self.pipeline = pipeline
        self.cell, self.device = cell, torch.device(cell.device)
        cfg, tr = cell.config, cell.traffic
        self.hop = cfg["vocoder_params"]["hop_size"]
        self.bucket_multiple, self.max_t2 = tr["bucket_multiple"], tr["max_t2"]
        b, n = tr["batch"], tr["batches"]
        seconds = corpus.planned(corpus.beta_quantiles(b * n), tr["plan_seed"]).reshape(n, b)
        chars = np.maximum(np.round(corpus.frames(seconds) / cfg["pinned_frames_per_symbol"]), 2).astype(int)
        rng = np.random.default_rng(weights.sub_seed(cell.seed, "text"))
        self.texts = [[corpus.sentence(rng, int(c)) for c in row] for row in chars]
        self.plan = []
        for row in self.texts:
            ids = [encode(t) for t in row]
            lengths = np.array([len(i) for i in ids], np.int64)
            text = np.zeros((b, lengths.max()), np.int64)
            for j, i in enumerate(ids):
                text[j, :len(i)] = i
            self.plan.append((text, lengths))
        self.trees = program.inference_trees(cfg, cell.seed, self.device)
        self.model, self.voc = program.inference_models(cfg, self.trees, self.device)
        # which row of the i-th fetched batch the check may take, drawn from the seed
        self.pick = np.random.default_rng(weights.sub_seed(cell.seed, "pick"))
        longest = int(np.argmax(seconds))
        self.longest = divmod(longest, b)
        for k in range(n):  # every batch of the plan once: each shape the window reaches
            self._fetch(self._dispatch(k))
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _dispatch(self, k: int):
        text, lengths = self.plan[k % len(self.plan)]
        timings = {}
        handle, wav_lengths = self.pipeline.synthesize_dispatch(
            self.model, self.voc, text, lengths, bucket_multiple=self.bucket_multiple, max_t2=self.max_t2,
            timings=timings, device=self.device)
        return k, handle, wav_lengths, timings

    def _fetch(self, pending):
        k, handle, wav_lengths, timings = pending
        return k, self.pipeline.fetch(handle), wav_lengths, timings

    def _loop(self, start: int, until, on_fetch) -> int:
        """Dispatch from plan batch `start` on while `until(n)` holds, each
        fetched after the next one's dispatch; returns the batches run."""
        pending, k = None, start
        while until(k - start):
            nxt = self._dispatch(k)
            if pending is not None:
                on_fetch(*self._fetch(pending))
            pending, k = nxt, k + 1
        if pending is not None:
            on_fetch(*self._fetch(pending))
        return k - start

    def window(self, seconds: float) -> dict:
        rows, kept, stats = [], {}, {"audio_s": 0.0, "real_frames": 0, "padded_frames": 0, "dispatch_s": []}
        b, n = len(self.texts[0]), len(self.plan)

        def on_fetch(k, wav, wav_lengths, timings):
            stats["audio_s"] += float(wav_lengths.sum()) / corpus.SAMPLE_RATE
            stats["real_frames"] += int(wav_lengths.sum()) // self.hop
            stats["padded_frames"] += b * int(timings["t2"])
            stats["dispatch_s"].append(timings["dispatch_s"])
            rows.append((k % n, wav_lengths.copy()))
            for r in {int(self.pick.integers(b))} | ({self.longest[1]} if k % n == self.longest[0] else set()):
                kept.setdefault((k % n, r), []).append(np.array(wav[r, :wav_lengths[r]]))

        t0 = time.perf_counter()
        n_batches = self._loop(0, lambda i: time.perf_counter() - t0 < seconds, on_fetch)
        window_s = time.perf_counter() - t0
        self.rows, self.kept = rows, kept
        mp, vp = self.cell.config["model_params"], self.cell.config["vocoder_params"]
        work = sum(flops.synthesis_flops(mp, vp, self.plan[k][1], wl // self.hop) for k, wl in rows)
        record = {"window_s": window_s, "flops": work, "batches": n_batches, **stats}
        return {"e2e": {"synth_audio_s_per_s": stats["audio_s"] / window_s}, "attempted": n_batches * b,
                "failed": 0, "record": record}

    def traced(self, n_batches: int = 6) -> dict:
        from port_bench.record import profile

        fetched = []
        out = profile(lambda: self._loop(0, lambda i: i < n_batches, lambda k, w, wl, t: fetched.append(wl)))
        vp = self.cell.config["vocoder_params"]
        out["k3_bound_s"] = sum(roofline.generator_mrf_bound_s(vp, wl // self.hop) for wl in fetched)
        return out

    def release(self) -> None:
        del self.model, self.voc
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _chosen(self) -> set:
        """The rows the check compares: a sample of the kept ones drawn from
        the seed, and the plan's longest when it was fetched."""
        keys = sorted(self.kept)
        rng = np.random.default_rng(weights.sub_seed(self.cell.seed, "check"))
        n = min(self.cell.traffic["check_rows"], len(keys))
        return {keys[i] for i in rng.choice(len(keys), n, replace=False)} | ({self.longest} & set(keys))

    def reference(self, ops, chosen: set, rows: int | None = None) -> dict:
        """The reference's outputs at precision `ops`: {"lengths": {batch: its
        rows' waveform lengths}, "wav": {(batch, row): waveform}}. With `rows`,
        each batch is cut to its first `rows` rows (a fault the check has to
        see: part of the batch left out)."""
        mp, vp = self.cell.config["model_params"], self.cell.config["vocoder_params"]
        acoustic, vocoder = self.trees
        out = {"lengths": {}, "wav": {}}
        with torch.no_grad(), ops.precision(self.device):
            for k in sorted({k for k, _ in self.rows}):
                text, lengths = (torch.from_numpy(a[:rows]).to(self.device) for a in self.plan[k])
                s1 = ref_efts.cnn_stage1(acoustic, mp, text, lengths, ops)
                t2 = min(ref_efts.bucket(int(s1["lengths"].max()), self.bucket_multiple), self.max_t2)
                out["lengths"][k] = torch.clamp(s1["lengths"], 1, t2).cpu().numpy() * self.hop
                picked = sorted(r for kk, r in chosen if kk == k and (rows is None or r < rows))
                if not picked:
                    continue
                mel, mel_lengths = ref_efts.cnn_decode(acoustic, mp, s1, picked, t2, ops)
                wav = ref_hifigan.generator(vocoder, vp, mel, ops)
                for j, r in enumerate(picked):
                    out["wav"][(k, r)] = wav[j, :int(mel_lengths[j]) * self.hop].float().cpu().numpy()
        return out

    def substitute(self, ops, rows: int | None = None) -> None:
        """Put the reference at `ops` (or cut to `rows` rows) in the program's
        place: what the window produced becomes its outputs."""
        ref = self.reference(ops, self._chosen(), rows)
        b = len(self.texts[0])
        self.rows = [(k, np.pad(ref["lengths"][k], (0, b - len(ref["lengths"][k])))) for k, _ in self.rows]
        self.kept = {key: [ref["wav"].get(key, np.zeros(0, np.float32))] for key in self.kept}

    def check(self, ops) -> dict:
        """len_mismatch: rows of the fetched batches whose waveform length is not
        the reference's mel length (clipped to the bucket its lengths pick)
        times the hop; wav_rel_err: over the sampled rows, the largest
        |program - reference| over the row's peak."""
        chosen = self._chosen()
        ref = self.reference(ops, chosen)
        mismatch = sum(int(np.sum(wl != ref["lengths"][k])) for k, wl in self.rows)
        worst = 0.0
        for key in chosen:
            want = ref["wav"][key]
            peak = max(float(np.abs(want).max()), 1e-30)
            for got in self.kept[key]:
                if got.shape != want.shape:
                    mismatch += 1
                else:
                    worst = max(worst, float(np.abs(got - want).max()) / peak)
        return {"len_mismatch": float(mismatch), "wav_rel_err": worst}
