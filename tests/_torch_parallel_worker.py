"""One rank of the port's multi-rank synthesis tests, on the CPU under gloo.

    python tests/_torch_parallel_worker.py TASK RANK WORLD INIT_URL OUT_DIR

Imports torch and the port only (neither JAX nor the tests' conftest). Every
rank builds the same seeded models (`efficient_tts_tpu_torch.init` through
`compat`), joins the group through INIT_URL (a file:// rendezvous), runs
TASK and writes what it got to OUT_DIR/TASK.rank<RANK>.npz:

  world2 (2 ranks): synthesize_fixed_sharded in dp (2, 1), tp (1, 2) and
         sp (1, 2), the parameter bytes of the tp copies, a ragged batch
         through synthesize(mesh=) on (2, 1), TTSEngine(mesh=) on (2, 1), and
         an EFTS-Transformer in tp (1, 2); the one-process synthesize_fixed
         and synthesize beside them;
  world4 (4 ranks): dp+tp and dp+sp on (2, 2), and the meshes (1, 2) and
         (data=None, model=2), their indices and membership.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from efficient_tts_tpu_torch import compat, init, pipeline  # noqa: E402
from efficient_tts_tpu_torch.models.efficient_tts import EftsCNNConfig  # noqa: E402
from efficient_tts_tpu_torch.models.efficient_tts_transformer import EftsTransformerConfig  # noqa: E402
from efficient_tts_tpu_torch.models.hifigan import HiFiGANConfig  # noqa: E402

# tests/test_sharded_synthesis.py's configs, batch and T2
EFTS_CFG = EftsCNNConfig(num_symbols=40, symbol_embedding_dim=64, n_channels=64, n_text_encoder_layer=2,
                         n_mel_encoder_layer=1, n_decoder_layer=2, n_duration_layer=2, dropout_rate=0.0,
                         use_masking=True)
VOC_CFG = HiFiGANConfig(upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4),
                        upsample_initial_channel=64, resblock_kernel_sizes=(3, 7),
                        resblock_dilation_sizes=((1, 3), (1, 3)))
T2 = 64
MODES = {"dp": (2, 1), "tp": (1, 2), "sp": (1, 2), "dp+tp": (2, 2), "dp+sp": (2, 2)}
# an EFTS-Transformer for tp: its attention projections are column-parallel linears
TR_CFG = EftsTransformerConfig(num_symbols=40, n_channels=64, n_heads=2, ff_hidden=128, n_text_encoder_layer=2,
                               n_mel_encoder_layer=1, n_decoder_layer=2, dropout_rate=0.0)
# the serving tests' char config (148 symbols) and a narrow generator
SERVE_EFTS_CFG = EftsCNNConfig(num_symbols=148, symbol_embedding_dim=32, n_channels=32, n_text_encoder_layer=1,
                               n_mel_encoder_layer=1, n_decoder_layer=1, dropout_rate=0.0, use_masking=True)
SERVE_VOC_CFG = HiFiGANConfig(upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                              resblock_dilation_sizes=((1, 2),))
TEXTS = ["Hello there.", "A much longer sentence to synthesize, really.", "Hi."]
# a duration bias that makes the ragged batch's halves fall in different mel buckets
RAGGED_DURATION_BIAS = 1.5


def batch():
    rng = np.random.default_rng(2)
    text = rng.integers(1, EFTS_CFG.num_symbols, size=(8, 12)).astype(np.int32)
    return text, np.asarray([12, 11, 10, 12, 9, 12, 8, 12], np.int32)


def ragged_batch():
    """4 short rows, then 4 long ones: split over 2 data ranks, each half alone
    would pick another bucket."""
    rng = np.random.default_rng(3)
    text = rng.integers(1, EFTS_CFG.num_symbols, size=(8, 40)).astype(np.int32)
    return text, np.asarray([2, 3, 2, 3, 40, 38, 36, 40], np.int32)


def trees(ragged=False):
    ep, vp = init.init_efts(0, EFTS_CFG), init.init_generator(1, VOC_CFG)
    if ragged:
        ep["duration_predictor"]["out"]["b"] = np.full((1,), RAGGED_DURATION_BIAS, np.float32)
    return ep, vp


def models(ragged=False):
    ep, vp = trees(ragged)
    return (compat.efts_cnn_from_jax(ep, EFTS_CFG, device="cpu"),
            compat.hifigan_generator_from_jax(vp, VOC_CFG, device="cpu"))


def serve_models():
    ep = init.init_efts(0, SERVE_EFTS_CFG)
    ep["duration_predictor"]["out"]["b"] = np.full((1,), 1.5, np.float32)
    return (compat.efts_cnn_from_jax(ep, SERVE_EFTS_CFG, device="cpu"),
            compat.hifigan_generator_from_jax(init.init_generator(1, SERVE_VOC_CFG), SERVE_VOC_CFG, device="cpu"))


def sharded_bytes(module, sharded):
    """Bytes of the tensors named in `sharded` that `module` holds."""
    named = {**dict(module.named_parameters()), **dict(module.named_buffers())}
    return sum(named[n].numel() * named[n].element_size() for n in sharded)


def run_modes(out, modes, meshes):
    from efficient_tts_tpu_torch.parallel import param_specs, shard_module

    model, voc = models()
    text, lengths = batch()
    # the one-process path in this process, at its thread count
    wav, wl, mel = pipeline.synthesize_fixed(model, voc, text, lengths, T2, device="cpu")
    out["one/wav"], out["one/wav_lengths"], out["one/mel"] = wav.numpy(), wl.numpy(), mel.numpy()
    for mode in modes:
        mesh = meshes[MODES[mode]]
        wav, wl, mel = pipeline.synthesize_fixed_sharded(model, voc, text, lengths, T2, mesh, mode=mode,
                                                         device="cpu")
        out[f"{mode}/wav"], out[f"{mode}/wav_lengths"], out[f"{mode}/mel"] = wav.numpy(), wl.numpy(), mel.numpy()
        if mode == "tp":
            for name, mod in (("efts", model), ("voc", voc)):
                sharded = [n for n, a in param_specs(mod, mesh).items() if a is not None]
                out[f"tp_bytes/{name}"] = np.asarray([sharded_bytes(mod, sharded),
                                                      sharded_bytes(shard_module(mod, mesh), sharded)])


def main():
    task, rank, world, url, out_dir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
    torch.set_num_threads(1)
    from efficient_tts_tpu_torch.parallel import initialize_multihost, make_mesh
    from efficient_tts_tpu_torch.serve import TTSEngine

    initialize_multihost(url, world, rank, device="cpu")
    initialize_multihost(url, world, rank, device="cpu")  # a second call returns
    out = {}
    if task == "world2":
        meshes = {(2, 1): make_mesh(2, 1), (1, 2): make_mesh(1, 2)}
        run_modes(out, ("dp", "tp", "sp"), meshes)
        tr = compat.efts_transformer_from_jax(init.init_efts_transformer(2, TR_CFG), TR_CFG, device="cpu")
        _, voc = models()
        for key, mesh in (("one", None), ("tp", meshes[1, 2])):
            got = (pipeline.synthesize_fixed(tr, voc, *batch(), T2, device="cpu") if mesh is None else
                   pipeline.synthesize_fixed_sharded(tr, voc, *batch(), T2, mesh, mode="tp", device="cpu"))
            for name, x in zip(("wav", "wav_lengths", "mel"), got):
                out[f"transformer_{key}/{name}"] = x.numpy()
        model, voc = models(ragged=True)
        wav, wl = pipeline.synthesize(model, voc, *ragged_batch(), device="cpu", mesh=meshes[2, 1])
        out["ragged/wav"], out["ragged/wav_lengths"] = wav, wl
        out["ragged/one_wav"], out["ragged/one_wav_lengths"] = pipeline.synthesize(model, voc, *ragged_batch(),
                                                                                   device="cpu")
        engine = TTSEngine(*serve_models(), device="cpu", max_batch=8, mesh=meshes[2, 1])
        for i, w in enumerate(engine.synthesize(TEXTS)):
            out[f"engine/{i}"] = w
    elif task == "world4":
        meshes = {(2, 2): make_mesh(2, 2)}
        run_modes(out, ("dp+tp", "dp+sp"), meshes)
        for name, mesh in (("mesh_1x2", make_mesh(1, 2)), ("mesh_auto", make_mesh(None, 2))):
            out[name] = np.asarray([mesh.shape["data"], mesh.shape["model"], mesh.member,
                                    -1 if mesh.data_index is None else mesh.data_index,
                                    -1 if mesh.model_index is None else mesh.model_index,
                                    mesh.data_group is not None, mesh.model_group is not None])
    else:
        raise SystemExit(f"unknown task {task!r}")
    np.savez(os.path.join(out_dir, f"{task}.rank{rank}.npz"), **out)
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main()
