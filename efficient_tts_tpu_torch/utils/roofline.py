"""Least times on an H100 SXM for the work of each ported or still-to-port kernel.

A bound is the larger of the bytes the function must move (each input read
once, each output written once) over the memory rate and its operations over
the card's peak for their type. `chip_smoke.py` uses these for its kernel
rows; run this module to print the bounds of every TPU kernel of the JAX
package at the shapes of its path:

    python -m efficient_tts_tpu_torch.utils.roofline

Peaks: NVIDIA's H100 SXM data sheet, dense, at the full 700 W power limit.
"tf32x3" is the TF32 rate over three: the f32 MRF kernel forms each f32
product from three TF32 products (3xTF32), so it counts the stage's f32
operations against a third of the TF32 peak.
"""

from __future__ import annotations

import json

PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12, "tf32x3": 495e12 / 3, "fp32": 67e12}
PEAK_BYTES = 3.35e12  # HBM3

# HiFi-GAN V1 MRF stages at B=16, T2=512: (channels, length)
MRF_STAGES = ((256, 4096), (128, 32768), (64, 65536), (32, 131072))
V1_KERNEL_SIZES = (3, 7, 11)
V1_CONVS_PER_BRANCH = 6  # dilations 1/3/5, two convs each
TRAIN_B = 64  # the EFTS-Transformer training batch
# (Tq, Tk) of the mel side's attention on a sequence-parallel rank: T2 = 512
# over 2 and 4 ranks, and the corpus's T2 = 640 over 4 (160 rows, which the
# kernels take padded to 192)
SP_FLASH_SHAPES = ((256, 512), (128, 512), (160, 640))


def bound_ms(ops: float, nbytes: float, peak: str) -> tuple[float, str]:
    """(least ms, "operations" or "bytes")."""
    by_ops, by_bytes = ops / PEAK_OPS[peak] * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes else "bytes")


def mrf_stage_work(b: int, t: int, c: int, taps, act_bytes: int, weight_bytes: float,
                   per_conv_vectors: int = 1) -> tuple[float, float]:
    """(operations, bytes) of one MRF stage: x read and the result written
    once in `act_bytes` per value, every conv's [k, C, C] weights once, and
    `per_conv_vectors` f32 [C] vectors per conv (the bias; int8 adds scales)."""
    ops = 2.0 * b * t * c * c * sum(taps)
    nbytes = 2 * b * t * c * act_bytes + sum(k * c * c for k in taps) * weight_bytes
    return ops, nbytes + len(taps) * c * 4 * per_conv_vectors


def flash_work(b: int, h: int, tq: int, tk: int, dk: int, segmented: bool) -> tuple[float, float]:
    """(operations, bytes) of the flash forward in f32, tq query rows against
    tk keys: q k^T and p v, q, k, v read and o written once, and the two
    int32 segment id arrays."""
    return (4.0 * b * h * tq * tk * dk,
            (2 * tq + 2 * tk) * b * h * dk * 4 + ((tq + tk) * b * 4 if segmented else 0))


def flash_backward_work(b: int, h: int, tq: int, tk: int, dk: int, part: str,
                        segmented: bool = False) -> tuple[float, float]:
    """(operations, bytes) of the backward's two kernels in f32: "dkv"
    recomputes s and dp and forms dv and dk (4 products), "dq" recomputes s
    and dp and forms dq (3). Each reads q, k, v, do, the [B, H, Tq] l, m and
    di and the two int32 segment id arrays once and writes its gradients
    (dk and dv of the tk keys, or dq of the tq rows) once."""
    n_products, out_rows = {"dkv": (4, 2 * tk), "dq": (3, tq)}[part]
    row = b * h * dk * 4
    return (2.0 * n_products * b * h * tq * tk * dk,
            (2 * tq + 2 * tk + out_rows) * row + 3 * b * h * tq * 4 + ((tq + tk) * b * 4 if segmented else 0))


def mrf_stage_launch_bytes(b: int, t: int, c: int, dilation_sizes, act_bytes: int = 2) -> dict:
    """Bytes that a stage run as one launch per conv must move, each launch
    reading its inputs and writing its output once (halos and weights left
    out): per dilation the dilated conv reads x and writes a scratch tensor,
    the d=1 conv reads it and the residual and writes the branch state, and
    each branch after the first adds into the running sum, one more read.
    V1 (3 branches of 3 dilations): 47 passes over [b, t, c]. Dynamic
    scales add the absmax launch's read of the stage input."""
    act = b * t * c * act_bytes
    n_branches = len(dilation_sizes)
    passes = sum(5 * len(dils) for dils in dilation_sizes) + (n_branches - 1)
    return {"passes": passes, "bytes": passes * act, "absmax_bytes": act}


def probe_work(m: int, repeat: int, elem_bytes: int, k: int = 128) -> tuple[float, float]:
    """(operations, bytes) of the rate probe: [m, k] x [k, k] applied
    `repeat` times per row, x and w read once and out written once."""
    return 2.0 * m * k * k * repeat, (m * k + k * k + m * k) * elem_bytes


def v1_taps():
    return [k for k in V1_KERNEL_SIZES for _ in range(V1_CONVS_PER_BRANCH)]


def table(b: int = 16) -> list[dict]:
    rows = []
    taps = v1_taps()
    # the MRF stage kernels: K3 f32 runs 3xTF32 products; the FP32 bound of
    # its earlier FFMA kernel is kept for the record
    for name, peak, act, wb, vecs in (("K1 mrf_stage bf16", "bf16", 2, 2, 1),
                                      ("K2 mrf_stage W8A8", "int8", 2, 1, 2),
                                      ("K3 mrf_stage f32", "tf32x3", 4, 4, 1),
                                      ("K3 mrf_stage f32 (FP32 record)", "fp32", 4, 4, 1)):
        stage_rows = []
        for c, t in MRF_STAGES:
            ops, nbytes = mrf_stage_work(b, t, c, taps, act, wb, vecs)
            ms, by = bound_ms(ops, nbytes, peak)
            stage_rows.append({"kernel": name, "shape": [b, t, c], "peak": peak, "ops": ops, "bytes": nbytes,
                               "bound_ms": ms, "bound_by": by})
        rows += stage_rows
        rows.append({"kernel": name, "shape": "the four V1 stages", "peak": peak,
                     "bound_ms": sum(r["bound_ms"] for r in stage_rows)})
    # K2 at the shape of bench/mrf_fused.py (scripts/bench_mrf_fused.py)
    ops, nbytes = mrf_stage_work(b, 262144, 32, taps, 2, 1, 2)
    ms, by = bound_ms(ops, nbytes, "int8")
    rows.append({"kernel": "K2 mrf_stage W8A8", "shape": [b, 262144, 32], "peak": "int8", "ops": ops,
                 "bytes": nbytes, "bound_ms": ms, "bound_by": by})
    # the 18-launch design's floor: not the bound, which counts one read of
    # x and one write of the result; what 18 unfused launches must move
    dils = ((1, 3, 5),) * len(V1_KERNEL_SIZES)
    for c, t in ((32, 262144), *MRF_STAGES):
        fl = mrf_stage_launch_bytes(b, t, c, dils)
        rows.append({"kernel": "K2 mrf_stage W8A8, 18-launch design's floor (not the bound)", "shape": [b, t, c],
                     "passes": fl["passes"], "bytes": fl["bytes"], "floor_ms": fl["bytes"] / PEAK_BYTES * 1e3,
                     "with_absmax_ms": (fl["bytes"] + fl["absmax_bytes"]) / PEAK_BYTES * 1e3})
    # synthesis (B=16) and the training batch, where every call is masked
    for bb, t, seg in ((b, 512, False), (b, 128, True), (TRAIN_B, 512, True), (TRAIN_B, 128, True)):
        ops, nbytes = flash_work(bb, 4, t, t, 96, seg)
        ms, by = bound_ms(ops, nbytes, "tf32")
        rows.append({"kernel": "K4 flash forward", "shape": [bb, 4, t, 96], "segment_ids": seg, "peak": "tf32",
                     "ops": ops, "bytes": nbytes, "bound_ms": ms, "bound_by": by})
    # the backward at the training batch (lj_efts_transformer_phnseq.yaml: 64)
    for part in ("dkv", "dq"):
        for t, seg in ((512, False), (128, True)):
            ops, nbytes = flash_backward_work(TRAIN_B, 4, t, t, 96, part, seg)
            ms, by = bound_ms(ops, nbytes, "tf32")
            rows.append({"kernel": f"K4 flash backward {part}", "shape": [TRAIN_B, 4, t, 96], "segment_ids": seg,
                         "peak": "tf32", "ops": ops, "bytes": nbytes, "bound_ms": ms, "bound_by": by})
    # a sequence-parallel rank's rows against the whole sequence (the mel
    # side of the transformer's step over m ranks): the real rows' work
    for tq, tk in SP_FLASH_SHAPES:
        for part in ("fwd", "dkv", "dq"):
            ops, nbytes = (flash_work(TRAIN_B, 4, tq, tk, 96, True) if part == "fwd"
                           else flash_backward_work(TRAIN_B, 4, tq, tk, 96, part, True))
            ms, by = bound_ms(ops, nbytes, "tf32")
            rows.append({"kernel": f"K4 flash {part}, sequence-parallel rows", "shape": [TRAIN_B, 4, tq, tk, 96],
                         "segment_ids": True, "peak": "tf32", "ops": ops, "bytes": nbytes, "bound_ms": ms,
                         "bound_by": by})
    # the rate probe: [M, 128] x [128, 128], 8 products per tile (scripts/probe_int8_pallas.py)
    m = 1 << 20
    for peak, elem in (("bf16", 2), ("int8", 1)):
        ops, nbytes = probe_work(m, 8, elem)
        ms, by = bound_ms(ops, nbytes, peak)
        rows.append({"kernel": "K5 matmul rate probe", "shape": [m, 128, 128], "peak": peak, "ops": ops,
                     "bytes": nbytes, "bound_ms": ms, "bound_by": by})
    return rows


if __name__ == "__main__":
    for row in table():
        print(json.dumps(row))
