"""Training steps: `make_train_step` under the configuration's optimizer, one step after another.

A plan of `batches` batches of the configuration's `batch_size` rows,
collated as the recipe's collate pads them (sorted by text length, text
padded to a multiple of `text_bucket`, mel to one of `mel_bucket`): mel
lengths from the corpus's duration quantiles in the plan's fixed order,
text lengths the frames over `frames_per_symbol`; random ids (1 to the
inventory's last, 0 is the pad) and random log-mel targets from the run
seed, made on the device. Step i takes plan batch i mod `batches` and a
dropout key (a CPU generator) seeded from the run seed and i.

Set-up builds the train state once and runs it through the plan's first
`batches` steps (every shape the window reaches), which are the window's
own call and feed. Of the first three it keeps what the check compares:
each step's loss, each leaf's norm of the first gradient as the optimizer
takes it (mu / (1 - b1) after step 1) and each leaf's norm of its change
over the three (read before step 4 moves it). The reference follows the
three steps from the same weights, batches and keys.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from port_bench import corpus, program, weights
from port_bench.reference.train import train_steps
from port_bench.work import flops

CHECKED_STEPS = 3


def _round_up(n: int, m: int) -> int:
    return -(-int(n) // m) * m


class Session:
    def __init__(self, cell):
        self.cell, self.device = cell, torch.device(cell.device)
        cfg, tr = cell.config, cell.traffic
        b, n = cfg["batch_size"], tr["batches"]
        if n < CHECKED_STEPS:
            raise ValueError(f"a training plan needs {CHECKED_STEPS} batches at least")
        seconds = corpus.planned(corpus.beta_quantiles(b * n), tr["plan_seed"]).reshape(n, b)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(weights.sub_seed(cell.seed, "batches"))
        odim, n_sym = cfg["model_params"]["odim"], cfg["model_params"]["num_symbols"]
        self.plan, self.lengths = [], []
        for row in seconds:
            mel_len = np.sort(corpus.frames(row))[::-1]  # longest mel first; text follows it
            text_len = np.maximum(np.round(mel_len / tr["frames_per_symbol"]), 1).astype(np.int64)
            t1, t2 = _round_up(text_len.max(), cfg["text_bucket"]), _round_up(mel_len.max(), cfg["mel_bucket"])
            tl = torch.from_numpy(text_len).to(self.device)
            ml = torch.from_numpy(mel_len.copy()).to(self.device)
            text = torch.randint(1, n_sym, (b, t1), generator=gen, device=self.device)
            text = text * (torch.arange(t1, device=self.device)[None, :] < tl[:, None])
            mel = torch.randn((b, t2, odim), generator=gen, device=self.device) * tr["mel_std"] + tr["mel_mean"]
            mel = mel * (torch.arange(t2, device=self.device)[None, :, None] < ml[:, None, None])
            self.plan.append({"text": text, "text_lengths": tl, "mel": mel, "mel_lengths": ml})
            self.lengths.append((text_len, mel_len))
        self.tree = program.training_tree(cfg, cell.seed, self.device)
        self.state, self.step_fn = program.training_step(cfg, self.tree, self.device)
        self.dropout = cfg["model_params"].get("dropout_rate", 0.0) > 0
        self._references = {}
        self.steps = 0
        params = dict(self.state["params"].named_parameters())
        self.paths = [p for p, _ in weights.leaves(self.tree)]
        names = [weights.port_name(p) for p in self.paths]
        if sorted(names) != sorted(params):
            raise RuntimeError(f"the port's parameters are not the weight tree's: {sorted(set(names) ^ set(params))}")
        losses = []
        for i in range(n):  # every batch of the plan once, the first three checked
            metrics = self._step()
            if i < CHECKED_STEPS:
                losses.append(metrics["loss"])
            if i == 0:
                mu = _moment(self.state["opt_state"])
                b1 = self._b1()
                self.first_grad = [float(torch.linalg.vector_norm(mu[nm])) / (1 - b1) for nm in names]
            if i == CHECKED_STEPS - 1:
                start = dict(weights.leaves(self.tree))
                self.change = [float(torch.linalg.vector_norm(params[nm].detach() - weights.port_layout(p, start[p])))
                               for nm, p in zip(names, self.paths)]
        self.loss = [float(x) for x in losses]
        self._sync()

    def _b1(self) -> float:
        return float(self.cell.config["optimizer_params"]["betas"][0])

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def key(self, i: int):
        return torch.Generator().manual_seed(weights.sub_seed(self.cell.seed, "dropout", i)) if self.dropout else None

    def _step(self) -> dict:
        i = self.steps
        self.state, metrics = self.step_fn(self.state, self.plan[i % len(self.plan)], self.key(i))
        self.steps += 1
        return metrics

    def window(self, seconds: float) -> dict:
        first = self.steps
        t0 = time.perf_counter()
        losses = []
        while time.perf_counter() - t0 < seconds:
            losses.append(self._step()["loss"])
        self._sync()
        window_s = time.perf_counter() - t0
        n = self.steps - first
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        work = sum(self._flops(i) for i in range(first, self.steps))
        record = {"window_s": window_s, "flops": work, "steps": n}
        return {"e2e": {"train_step_ms": 1e3 * window_s / n}, "attempted": n, "failed": failed, "record": record}

    def _flops(self, i: int) -> float:
        cfg = self.cell.config
        return flops.train_step_flops(cfg["model_name"], cfg["model_params"], *self.lengths[i % len(self.lengths)])

    def traced(self, n_steps: int = 3) -> dict:
        from port_bench.record import profile

        def run():
            for _ in range(n_steps):
                self._step()
            return n_steps

        return profile(run)

    def release(self) -> None:
        del self.state, self.step_fn
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, ops, rows: int | None = None) -> dict:
        """The reference's three steps at precision `ops` (see
        `reference/train.py:train_steps`); with `rows`, on each batch's first
        `rows` rows only (a fault the check has to see: part of the batch
        left out, the mean taken over the rest)."""
        key = (ops.tf32, rows)
        if key not in self._references:
            batches = [{k: v[:rows] for k, v in b.items()} for b in self.plan[:CHECKED_STEPS]]
            self._references[key] = train_steps(self.tree, self.cell.config, batches,
                                                [self.key(i) for i in range(CHECKED_STEPS)], ops)
        return self._references[key]

    def substitute(self, ops, rows: int | None = None) -> None:
        """Put the reference at `ops` (or cut to `rows` rows) in the program's place."""
        ref = self.reference(ops, rows)
        self.loss, self.first_grad, self.change = ref["loss"], ref["first_grad"], ref["change"]

    def check(self, ops) -> dict:
        """loss_gap: the largest |program - reference| / |reference| of the
        three steps' losses. grad_gap, update_gap: by the worst leaf, the gap
        between the program's and the reference's norms of the first gradient
        (as the optimizer takes it) and of the change over the three steps,
        over the larger of that leaf's reference norm and the median leaf's;
        the change leaves out leaves whose first raw gradient in the reference
        is under a thousandth of the median leaf's (they move by round-off)."""
        ref = self.reference(ops)
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(self.loss, ref["loss"]))
        grad_gap = _worst_leaf(self.first_grad, ref["first_grad"])
        floor = 1e-3 * statistics.median(ref["raw_grad"])
        moving = [i for i, g in enumerate(ref["raw_grad"]) if g >= floor]
        update_gap = _worst_leaf([self.change[i] for i in moving], [ref["change"][i] for i in moving])
        return {"loss_gap": loss_gap, "grad_gap": grad_gap, "update_gap": update_gap}

    def worst_leaves(self, ops, n: int = 4) -> dict:
        """The `n` leaves of the largest grad and update gaps: [(path, gap,
        reference norm / median, first raw gradient / median)]."""
        ref = self.reference(ops)
        raw_med = statistics.median(ref["raw_grad"])
        out = {}
        for key, mine, theirs in (("grad", self.first_grad, ref["first_grad"]), ("update", self.change, ref["change"])):
            gaps = leaf_gaps(mine, theirs)
            med = statistics.median(theirs)
            top = sorted(range(len(gaps)), key=lambda i: -gaps[i])[:n]
            out[key] = [(weights.port_name(self.paths[i]), gaps[i], theirs[i] / med, ref["raw_grad"][i] / raw_med)
                        for i in top]
        return out


def leaf_gaps(program: list, reference: list) -> list:
    """Each leaf's gap as `_worst_leaf` measures it."""
    med = statistics.median(reference)
    return [abs(a - b) / max(b, med, 1e-30) for a, b in zip(program, reference)]


def _worst_leaf(program: list, reference: list) -> float:
    med = statistics.median(reference)
    return max(abs(a - b) / max(b, med, 1e-30) for a, b in zip(program, reference))


def _moment(opt_state) -> dict:
    """The first moment of the port's optimizer state by parameter name."""
    if isinstance(opt_state, dict) and "mu" in opt_state:
        return opt_state["mu"]
    raise TypeError("the configuration's optimizer keeps no first moment 'mu' the check can read")
