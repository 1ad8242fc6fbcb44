"""Sequence parallelism for the acoustic models' training: the mel frames
split over the mesh's 'model' axis.

Counterpart of JAX's `sequence_parallel=True` (`efficient_tts_tpu/train/
efts_train_step.py:57-73`), where GSPMD partitions the mel encoder, the
alignment tensors [B, T1, T2] and the decoder along T2. Here each rank of a
model row holds T2 / m consecutive frames of its data block (global frame
indices for the masks and positions) and the whole text side, and
`EftsCNN.forward(..., sp=SeqShard(mesh))` and
`EftsTransformer.forward(..., sp=)` compute:

  * the res-conv towers on the rank's frames, each conv's input extended by
    (k - 1) / 2 * dilation frames of the neighbouring ranks (`halo`; zeros at
    the sequence's ends), which is the 'SAME' conv of the whole sequence;
  * `imv_from_alpha`: the first difference takes the previous rank's last
    frame, the cumsum adds the sum of the ranks before, and the max over T2
    is an all-reduce max;
  * `aligned_positions`: the softmax over T2 all-reduces its max, its sum of
    exponentials and the weighted positions;
  * the losses: the rank's part of the block's masked means, over the
    block's counts, which the lengths give; the duration loss, replicated on
    the row, is carried by the row's first rank only;
  * the transformer's self-attention over T2 (`nn/attention.py`): the
    queries of the rank's frames against the keys and values of the whole
    sequence, which `gather` collects from the row; its 'SAME' convs take
    halos and its position-wise layers stay on the rank's frames.

Each rank's loss is its part of the global loss and the collectives'
backward sums the ranks' gradients (`parallel/tensor_parallel.py`), so the
parameters' gradients, summed over the ranks, are the whole batch's.
Dropout on a rank's frames takes its window of the mask the whole sequence
would draw: every rank of the row holds the same generator.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from efficient_tts_tpu_torch.losses.fastspeech import LOSS_NORMALIZE
from efficient_tts_tpu_torch.nn.layers import conv1d, dropout
from efficient_tts_tpu_torch.ops.alignment import _NEG
from efficient_tts_tpu_torch.parallel.mesh import MODEL_AXIS
from efficient_tts_tpu_torch.parallel.tensor_parallel import (all_gather_stack, all_reduce_max, all_reduce_sum)


class SeqShard:
    """This rank's share of the mel frames on `mesh`'s 'model' axis."""

    def __init__(self, mesh):
        self.group, self.index, self.extent = mesh.model_group, mesh.model_index, mesh.shape[MODEL_AXIS]

    def frames(self, t2: int) -> slice:
        """The rank's frames of a global length t2."""
        if t2 % self.extent:
            raise ValueError(f"mel length {t2} not divisible by the sequence-parallel extent {self.extent}")
        n = t2 // self.extent
        return slice(self.index * n, (self.index + 1) * n)

    def positions(self, t: int, device) -> torch.Tensor:
        """The global indices [t] of the rank's t frames."""
        return torch.arange(self.index * t, (self.index + 1) * t, device=device)

    def mask(self, lengths: torch.Tensor, t: int) -> torch.Tensor:
        """[B, t] True on the rank's valid frames."""
        return self.positions(t, lengths.device)[None, :].to(lengths.dtype) < lengths[:, None]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """[B, t * m, ...]: the frames x [B, t, ...] of every rank of the row,
        in order. The backward sums the gradient over the row and keeps the
        rank's frames (`all_gather_stack`): every rank's queries add a part
        to each key's and value's gradient."""
        return torch.cat(all_gather_stack(x, self.group).unbind(0), dim=1)

    def halo(self, x: torch.Tensor, left: int, right: int) -> torch.Tensor:
        """x [B, t, ...] with `left` frames of the previous rank before it and
        `right` of the next after it (zeros past the sequence's ends)."""
        t = x.shape[1]
        if max(left, right) > t:
            raise ValueError(f"a halo of {max(left, right)} frames exceeds the rank's {t}")
        edges = all_gather_stack(torch.cat([x[:, :right], x[:, t - left:]], dim=1), self.group)
        # every rank takes part in the same graph, so the ranks' backward
        # passes run their collectives in the same order: a missing
        # neighbour is a zero times a neighbour's edge, not a new tensor
        i, m = self.index, self.extent
        before = edges[max(i - 1, 0)][:, right:] * float(i > 0)
        after = edges[min(i + 1, m - 1)][:, :right] * float(i < m - 1)
        return torch.cat([before, x, after], dim=1)

    def conv(self, layer, x: torch.Tensor) -> torch.Tensor:
        """A 'SAME' stride-1 conv (`Conv1d` or `WNConv1d`) on the rank's frames."""
        w = layer.weight() if callable(layer.weight) else layer.weight
        pad = (w.shape[-1] - 1) // 2 * layer.dilation
        return conv1d(self.halo(x, pad, pad), w, layer.bias, layer.dilation, padding=0)

    def dropout(self, x: torch.Tensor, rate: float, gen, deterministic: bool) -> torch.Tensor:
        """Dropout of the rank's frames [B, t, C] with their window of the
        whole sequence's mask."""
        return dropout(x, rate, gen, deterministic, window=(x.shape[1] * self.extent, self.index * x.shape[1]))

    def imv_from_alpha(self, alpha, p, mel_mask, text_lengths):
        """`ops/alignment.py:imv_from_alpha` on the rank's frames [B, t]."""
        imv_dummy = torch.einsum("bst,bs->bt", alpha, p)
        ext = self.halo(imv_dummy[:, :, None], 1, 0)[:, :, 0]
        delta = torch.maximum(ext[:, 1:] - ext[:, :-1], torch.zeros((), dtype=ext.dtype, device=ext.device))
        # the sequence's first difference is 0 (on every rank the same graph,
        # as in `halo`)
        first = torch.ones(delta.shape[1], device=delta.device)
        first[0] = float(self.index > 0)
        cum = torch.cumsum(delta * first, dim=-1)
        totals = all_gather_stack(cum[:, -1], self.group)
        before = (torch.arange(self.extent, device=cum.device) < self.index).to(cum.dtype)
        imv = (cum + (totals * before[:, None]).sum(dim=0)[:, None]) * mel_mask.float()
        last = torch.maximum(all_reduce_max(imv, self.group), torch.tensor(1e-8, device=imv.device))
        scale = (text_lengths.float() - 1.0) / last
        return imv * scale[:, None]

    def aligned_positions(self, imv, p, mel_mask, text_mask, sigma_e: float = 0.5):
        """`ops/alignment.py:aligned_positions`, its softmax over the frames of
        every rank; e [B, T1] is whole on every rank. The max is taken without
        a gradient: the softmax does not depend on it."""
        energies = -sigma_e * torch.square(imv[:, None, :] - p[:, :, None])
        mask = mel_mask[:, None, :]
        scores = torch.where(mask, energies, torch.full_like(energies, _NEG))
        m = scores.detach().amax(dim=-1, keepdim=True)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=self.group)
        ex = torch.exp(scores - m) * mask
        beta = ex / torch.clamp(all_reduce_sum(ex.sum(dim=-1, keepdim=True), self.group), min=1e-30)
        q = self.positions(imv.shape[1], imv.device).float()[None, :] * mel_mask.float()
        e = all_reduce_sum(torch.einsum("bst,bt->bs", beta, q), self.group)
        return e * text_mask.float()

    def fastspeech_loss(self, mel_pred, mel_target, dur_pred, dur_target, text_mask, mel_mask, mel_lengths,
                        use_masking: bool = True, loss_normalize: str = "frame"):
        """The rank's part of `losses/fastspeech.py:fastspeech_loss` of the
        block: the mel terms of its frames over the block's counts, and the
        duration loss on the row's first rank (0 on the others)."""
        if loss_normalize not in LOSS_NORMALIZE:
            raise ValueError(f"loss_normalize={loss_normalize!r}: expected one of {LOSS_NORMALIZE}")
        mel_err = torch.square(mel_pred - mel_target)
        dur_err = torch.abs(dur_pred - dur_target)
        odim = mel_err.shape[-1]
        first = float(self.index == 0)
        if not use_masking:
            return mel_err.sum() / (mel_err.numel() * self.extent), dur_err.mean() * first
        mel_maskf = mel_mask.to(mel_err.dtype)[:, :, None]
        text_maskf = text_mask.to(dur_err.dtype)
        frames = mel_lengths.to(mel_err.dtype)
        if loss_normalize == "utterance":
            per_mel = (mel_err * mel_maskf).sum(dim=(1, 2)) / torch.clamp(frames * odim, min=1.0)
            tokens = text_maskf.sum(dim=1)
            per_dur = (dur_err * text_maskf).sum(dim=1) / torch.clamp(tokens, min=1.0)
            valid = (tokens > 0).to(mel_err.dtype)
            n_valid = torch.clamp(valid.sum(), min=1.0)
            return (per_mel * valid).sum() / n_valid, (per_dur * valid).sum() / n_valid * first
        mel_loss = (mel_err * mel_maskf).sum() / torch.clamp(frames.sum() * odim, min=1.0)
        dur_loss = (dur_err * text_maskf).sum() / torch.clamp(text_maskf.sum(), min=1.0)
        return mel_loss, dur_loss * first
