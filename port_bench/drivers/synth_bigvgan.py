"""Offline batched synthesis into BigVGAN: `synth`'s traffic and loop, with BigVGAN in HiFi-GAN's place.

What `drivers/synth.py` does, on a configuration whose `vocoder_name` is
"BigVGAN": the same plan, window, late fetch, `substitute` and `check`
(inherited). What differs: the set-up builds the vocoder from a seeded
state dict in NVIDIA/BigVGAN's published layout (`weights_bigvgan.py`)
through the port's loader (`compat.bigvgan_generator_from_state_dict`); the
reference vocodes with `reference/bigvgan.py` from the same state dict; the
traced stretch records the least time of the anti-aliased activations'
bytes (`work/bigvgan.py`) for `bigvgan_act_roofline`. A port without that
loader fails at the set-up's first line.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from port_bench import corpus, program, weights, weights_bigvgan
from port_bench.drivers import synth
from port_bench.reference import bigvgan as ref_bigvgan
from port_bench.reference import efts as ref_efts
from port_bench.reference.text import encode
from port_bench.work import bigvgan as bigvgan_work


class Session(synth.Session):
    def __init__(self, cell):
        from efficient_tts_tpu_torch.compat import bigvgan_generator_from_state_dict, efts_cnn_from_jax
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
        mp = cfg["model_params"]
        pin = math.log(cfg["pinned_frames_per_symbol"] + mp["duration_offset"])
        acoustic = weights.make_tree(weights.efts_cnn_spec(mp, training=False, pin=pin),
                                     weights.sub_seed(cell.seed, "acoustic"), self.device)
        vocoder = weights_bigvgan.make_state_dict(cfg["vocoder_params"], weights.sub_seed(cell.seed, "vocoder"),
                                                  self.device)
        self.trees = acoustic, vocoder
        self.model = efts_cnn_from_jax(weights.to_numpy(acoustic), program.model_config(cfg), device=self.device)
        self.voc = bigvgan_generator_from_state_dict(vocoder, program.vocoder_config(cfg), device=self.device)
        self.pick = np.random.default_rng(weights.sub_seed(cell.seed, "pick"))
        self.longest = divmod(int(np.argmax(seconds)), b)
        for k in range(n):  # every batch of the plan once: each shape the window reaches
            self._fetch(self._dispatch(k))
        self._sync()

    def traced(self, n_batches: int = 6) -> dict:
        from port_bench.record import profile

        fetched = []
        out = profile(lambda: self._loop(0, lambda i: i < n_batches, lambda k, w, wl, t: fetched.append(wl)))
        vp = self.cell.config["vocoder_params"]
        out["bigvgan_act_bound_s"] = sum(bigvgan_work.act_bound_s(vp, wl // self.hop) for wl in fetched)
        return out

    def reference(self, ops, chosen: set, rows: int | None = None) -> dict:
        """`synth.Session.reference` with BigVGAN's reference as the vocoder."""
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
                wav = ref_bigvgan.generator(vocoder, vp, mel, ops)
                for j, r in enumerate(picked):
                    out["wav"][(k, r)] = wav[j, :int(mel_lengths[j]) * self.hop].float().cpu().numpy()
        return out
