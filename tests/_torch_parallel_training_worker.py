"""One rank of the port's multi-rank training tests, on the CPU under gloo.

    python tests/_torch_parallel_training_worker.py TASK RANK WORLD INIT_URL OUT_DIR

Imports torch and the port only (neither JAX nor the tests' conftest). Every
rank builds the same seeded models (`efficient_tts_tpu_torch.init` through
`compat`), joins the group through INIT_URL (a file:// rendezvous), runs
TASK and writes what it got to OUT_DIR/TASK.rank<RANK>.npz; its log gives
each phase's wall time. A train state is recorded gathered into the
one-card state and in the JAX tree's layout (`flat` keys: the tree's path
joined by "/"). The trainers' eval images are not drawn.

  world2 (2 ranks): EFTS-CNN two steps under dp (2, 1) on a batch whose rows
         are short on data row 0 and long on row 1 (also with 2
         micro-batches a rank), tp (1, 2) and sp (1, 2); one step under dp
         with 2 micro-batches for each of `DP_VARIANTS`' normalizations;
         the EFTS-Transformer under dp, tp and sp; the GAN under dp (2, 1); the
         tp gradients of EFTS-CNN and of a generator (transposed convs
         included) beside the whole model's; EftsTrainer evals, and
         checkpoints saved at dp 2 and tp 2 and one more step on each mesh;
         then the two CLIs,
         bin.train and bin.train_vocoder, 2 steps each on the corpus of
         OUT_DIR/paths.json, counting each rank's writes;
  world4 (4 ranks): EFTS-CNN under dp+tp and dp+sp (2, 2), the
         EFTS-Transformer under dp+sp, the GAN under dp+tp, and EFTS-CNN under dp+tp with dropout 0.1 with the dropout
         masks of every rank;
  one (1 process, no group): the one-process references: two steps of
         EFTS-CNN and of the EFTS-Transformer, one GAN step, and the one-card
         CLIs (bin.train, and bin.train_vocoder on the host path).
"""

import dataclasses
import hashlib
import json
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from efficient_tts_tpu_torch import compat, init  # noqa: E402
from efficient_tts_tpu_torch.models.efficient_tts import EftsCNNConfig  # noqa: E402
from efficient_tts_tpu_torch.models.efficient_tts_transformer import EftsTransformerConfig  # noqa: E402
from efficient_tts_tpu_torch.models.hifigan import HiFiGANConfig  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CNN_CFG = EftsCNNConfig(num_symbols=40, odim=20, symbol_embedding_dim=64, n_channels=64, n_text_encoder_layer=2,
                        n_mel_encoder_layer=2, n_decoder_layer=2, dropout_rate=0.0, use_masking=True)
TR_CFG = EftsTransformerConfig(num_symbols=40, odim=20, n_channels=64, n_heads=2, ff_hidden=128,
                               n_text_encoder_layer=2, n_mel_encoder_layer=2, n_decoder_layer=2, dropout_rate=0.0)
# the narrow generator of tests/test_torch_port_gan.py on segments of 1024
# samples (4 mel frames: the MPD's and MSD's strides still leave 2 and 4 frames)
VOC_CFG = HiFiGANConfig(upsample_initial_channel=64, resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
                        segment_size=1024)
# the other two normalizations of the losses' counts
CNN_UTT_CFG = dataclasses.replace(CNN_CFG, loss_normalize="utterance")
CNN_NOMASK_CFG = dataclasses.replace(CNN_CFG, use_masking=False)
MODES = {"dp": (2, 1), "tp": (1, 2), "sp": (1, 2), "dp+tp": (2, 2), "dp+sp": (2, 2)}
# dp variants held to JAX's step after one update: (config, accum_steps);
# each block's share of a micro-batch is by the normalization's own count
DP_VARIANTS = {"dp_utt_accum2": (CNN_UTT_CFG, 2), "dp_nomask_accum2": (CNN_NOMASK_CFG, 2)}
METRICS = ("loss", "mel_loss", "duration_loss", "grad_norm")
GAN_METRICS = ("d_loss", "d_mpd", "d_msd", "g_loss", "mel_l1", "fm", "adv")
# rows 0-3 (data row 0) short, rows 4-7 (data row 1) long: the blocks' means
# weigh very differently from the global masked mean
TEXT_LENGTHS = (8, 5, 11, 6, 24, 21, 23, 19)
MEL_LENGTHS = (22, 14, 30, 18, 64, 57, 61, 52)
GAN_LR = 2e-4


def batch(b=8, t1=24, t2=64, odim=20):
    rng = np.random.default_rng(0)
    tl, ml = np.array(TEXT_LENGTHS[:b], np.int32), np.array(MEL_LENGTHS[:b], np.int32)
    text = np.zeros((b, t1), np.int32)
    for i, n in enumerate(tl):
        text[i, :n] = rng.integers(1, 40, n)
    mel = rng.standard_normal((b, t2, odim)).astype(np.float32)
    mel *= np.arange(t2)[None, :, None] < ml[:, None, None]
    return {"text": text, "text_lengths": tl, "mel": mel, "mel_lengths": ml}


def gan_batch(b=2, segment=1024):
    """A 220 Hz tone plus seeded noise, its mel and its full-band loss mel
    (the port's numpy DSP)."""
    from efficient_tts_tpu_torch.dsp.mel import MelConfig, loss_mel_config, mel_spectrogram_np

    rng = np.random.default_rng(0)
    t = np.arange(segment) / 22050.0
    audio = 0.5 * np.sin(2 * np.pi * 220 * t)[None, :] * np.ones((b, 1))
    audio = (audio + 0.01 * rng.standard_normal((b, segment))).astype(np.float32)
    mel = np.stack([mel_spectrogram_np(a, MelConfig()).T for a in audio]).astype(np.float32)
    mel_loss = np.stack([mel_spectrogram_np(a, loss_mel_config(MelConfig(), None)).T for a in audio])
    return {"mel": mel, "audio": audio, "mel_loss": mel_loss.astype(np.float32)}


def optimizer_config():
    """The char yaml's optimizer, its warmup cut to 4 steps (as
    `tests/test_torch_port_cnn_training.py` cuts it)."""
    from efficient_tts_tpu_torch.utils.config import load_config

    config = load_config(os.path.join(REPO, "efficient_tts_tpu_torch", "configs", "lj_efts_cnn_char.yaml"))
    config["scheduler_params"] = {"warmup_steps": 4}
    return config


def flat(tree, prefix=""):
    """{path joined by '/': numpy leaf} of a nested dict / list tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree, np.float32)}
    out = {}
    for k, v in items:
        out.update(flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def tree(cfg) -> dict:
    """The acoustic model's seeded parameters (seed 0) in the JAX tree's layout."""
    return init.init_efts(0, cfg) if isinstance(cfg, EftsCNNConfig) else init.init_efts_transformer(0, cfg)


def acoustic(cfg):
    """(JAX tree of seed 0, its trainable port model on the CPU, the model's to_jax)."""
    params = tree(cfg)
    if isinstance(cfg, EftsCNNConfig):
        return params, compat.efts_cnn_from_jax(params, cfg, device="cpu", trainable=True), compat.efts_cnn_to_jax
    return (params, compat.efts_transformer_from_jax(params, cfg, device="cpu", trainable=True),
            compat.efts_transformer_to_jax)


def acoustic_jax(cfg, params: dict, grads: dict | None = None) -> dict:
    """A one-card state dict (and named tensors standing for its gradients)
    in the JAX tree's layout."""
    _, model, to_jax = acoustic(cfg)
    model.load_state_dict(params)
    if grads is None:
        return to_jax(model)
    for n, p in model.named_parameters():
        p.grad = grads[n].clone()
    return to_jax(model, grads=True)


def record_acoustic(out, key, cfg, whole, step):
    out.update({f"{key}/p{step}/{k}": v for k, v in flat(acoustic_jax(cfg, whole["params"])).items()})
    if step == 1:
        mu = whole["opt_state"]["mu"]
        out.update({f"{key}/mu1/{k}": v for k, v in flat(acoustic_jax(cfg, whole["params"], mu)).items()})


def train_mode(out, key, cfg, mesh, sp=False, dropout_seed=None, accum=1, steps=2):
    """`steps` steps of the acoustic model on `mesh`; the global metrics,
    the gathered state after each step (every rank records it) and the
    block's own mean loss (what a naive average of the ranks would take)."""
    from efficient_tts_tpu_torch.parallel import data_seed, gather_train_state
    from efficient_tts_tpu_torch.train.efts_train_step import make_train_step, shard_batch, shard_state
    from efficient_tts_tpu_torch.train.optim import optimizer_from_dict

    _, model, _ = acoustic(cfg)
    blk = shard_batch(batch(), mesh, accum, device="cpu")
    with torch.no_grad():
        out[f"{key}/block_loss"] = np.float32(model(blk["text"], blk["text_lengths"], blk["mel"],
                                                    blk["mel_lengths"])["loss"])
    tx = optimizer_from_dict(optimizer_config())
    state = shard_state(model, tx, mesh, sequence_parallel=sp, device="cpu")
    step = make_train_step(cfg, tx, mesh=mesh, sequence_parallel=sp, accum_steps=accum, device="cpu")
    gen = None if dropout_seed is None else torch.Generator().manual_seed(data_seed(dropout_seed, mesh))
    for i in range(1, steps + 1):
        state, m = step(state, blk, gen)
        out[f"{key}/m{i}"] = np.array([float(m[k]) for k in METRICS], np.float64)
        record_acoustic(out, key, cfg, gather_train_state(state, mesh), i)
    return state


def gan_leaves(tree: dict) -> dict:
    """The GAN leaves the tests hold: the whole generator, each
    discriminator's first conv and conv_post and the second conv of the
    second MPD and MSD discriminators (the V1 discriminators' 70 M parameters
    would make every record about 0.3 GB)."""
    return {k: v for k, v in flat(tree).items() if k.startswith("gen/params/")
            or (k.startswith("disc/params/") and ("/convs/0/" in k or "/conv_post/" in k
                                                  or "/discriminators/1/convs/1/" in k))}


def gan_state_whole(tx):
    return compat.gan_state_from_jax(init.init_gan_state(0, VOC_CFG), VOC_CFG, tx, tx, device="cpu")


def gan_mode(out, key, mesh):
    """One GAN step on `mesh` from `shard_gan_state`: the metrics, and the
    gathered state's parameters and first moments in the JAX layout."""
    from efficient_tts_tpu_torch.models.hifigan_train import HiFiGANTrainGenerator
    from efficient_tts_tpu_torch.parallel import gather_train_state, split_batch
    from efficient_tts_tpu_torch.train.hifigan_train_step import make_gan_train_step, shard_gan_state
    from efficient_tts_tpu_torch.train.optim import HiFiGANAdam

    tx = HiFiGANAdam(lr=GAN_LR)
    state = shard_gan_state(0, VOC_CFG, tx, tx, mesh, device="cpu")
    step = make_gan_train_step(VOC_CFG, tx, tx, device="cpu", mesh=mesh)
    blk = {k: split_batch(v, mesh) for k, v in gan_batch().items()}
    state, m = step(state, blk)
    out[f"{key}/m1"] = np.array([float(m[k]) for k in GAN_METRICS], np.float64)
    whole = gather_train_state(state, mesh)
    gen = HiFiGANTrainGenerator(VOC_CFG)
    gen.load_state_dict(whole["gen"]["params"])
    # the discriminators are replicated: the rank's own are the whole ones
    one = {"gen": {"params": gen}, "disc": {"params": state["disc"]["params"]}, "step": state["step"]}
    mu = {side: whole[side]["opt_state"]["mu"] for side in ("gen", "disc")}
    out.update({f"{key}/p1/{k}": v for k, v in gan_leaves(compat.gan_state_to_jax(one)).items()})
    out.update({f"{key}/mu1/{k}": v for k, v in gan_leaves(compat.gan_state_to_jax(one, grads=mu)).items()})
    out[f"{key}/sn_u"] = state["disc"]["params"].msd.discriminators[0].convs[0].u.numpy()


def tp_gradients(out, mesh):
    """The tp copies' gradients beside the whole models' on the same input:
    EFTS-CNN's loss on the whole batch, and a generator's (transposed convs
    with their cross-shard norm) output against a fixed random weighting."""
    from efficient_tts_tpu_torch.parallel import shard_module

    _, model, _ = acoustic(CNN_CFG)
    tp = shard_module(model, mesh, trainable=True)
    b = {k: torch.from_numpy(v).long() if k != "mel" else torch.from_numpy(v) for k, v in batch().items()}
    for key, mod in (("whole", model), ("tp", tp)):
        mod(b["text"], b["text_lengths"], b["mel"], b["mel_lengths"])["loss"].backward()
        for n, p in mod.named_parameters():
            out[f"cnn_grad_{key}/{n}"] = p.grad.numpy()
    out["cnn_specs"] = np.array(json.dumps(tp.shard_specs))
    gen = compat.generator_from_jax(init.init_generator(1, VOC_CFG), VOC_CFG, device="cpu")
    for p in gen.parameters():
        p.requires_grad_(True)
    gen_tp = shard_module(gen, mesh, trainable=True)
    mel = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 8, 80)).astype(np.float32))
    weight = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 8 * 256)).astype(np.float32))
    for key, mod in (("whole", gen), ("tp", gen_tp)):
        y = mod(mel)
        out[f"gen_out_{key}"] = y.detach().numpy()
        (y * weight).sum().backward()
        for n, p in mod.named_parameters():
            out[f"gen_grad_{key}/{n}"] = p.grad.numpy()
    out["gen_specs"] = np.array(json.dumps(gen_tp.shard_specs))
    out["gen_ups0_weight_tp"] = gen_tp.ups[0].kernel().detach().numpy()
    out["gen_ups0_weight_whole"] = gen.ups[0].weight().detach().numpy()


def checkpoints(out, meshes, out_dir, rank):
    """EftsTrainer on dp 2 and tp 2: one step, a save (rank 0 writes the
    gathered one-card file), then one more step; each rank's count of writes."""
    from efficient_tts_tpu_torch.data.loader import device_prefetch
    from efficient_tts_tpu_torch.parallel import gather_train_state
    from efficient_tts_tpu_torch.train import checkpoint as ckpt
    from efficient_tts_tpu_torch.train import efts_trainer
    from efficient_tts_tpu_torch.train.efts_train_step import BATCH_DTYPES
    from efficient_tts_tpu_torch.train.optim import optimizer_from_dict

    writes = []
    real = ckpt.save_checkpoint

    def counted(*a, **k):
        writes.append(rank)
        return real(*a, **k)

    efts_trainer.ckpt.save_checkpoint = counted
    try:
        for key, mesh in (("ckpt_dp", meshes["dp"]), ("ckpt_tp", meshes["tp"])):
            _, model, _ = acoustic(CNN_CFG)
            tx = optimizer_from_dict(optimizer_config())
            outdir = os.path.join(out_dir, key)
            blocks = device_prefetch(iter([(0, batch())] * 2), device="cpu", dtypes=BATCH_DTYPES, mesh=mesh)
            trainer = efts_trainer.EftsTrainer(CNN_CFG, tx, blocks, eval_batches=[batch()],
                                               outdir=outdir, train_max_steps=1, save_interval_steps=1000,
                                               eval_interval_steps=1000, log_interval_steps=1, device="cpu",
                                               mesh=mesh)
            trainer.init_state(model)
            trainer.run()
            evaluated = trainer.evaluate(1)
            out[f"{key}/eval"] = np.array([evaluated[k] for k in METRICS[:3]])
            out[f"{key}/path"] = np.array(trainer.save())
            trainer.train_max_steps = 2
            trainer.run()
            record_acoustic(out, key, CNN_CFG, gather_train_state(trainer.state, mesh), 2)
    finally:
        efts_trainer.ckpt.save_checkpoint = real
    out["ckpt/writes"] = np.array(len(writes))


def clis(out, url, world, rank, out_dir):
    """bin.train and bin.train_vocoder over the ranks, 2 steps each, every
    write of a config or a checkpoint counted."""
    from efficient_tts_tpu_torch.bin import train, train_vocoder
    from efficient_tts_tpu_torch.train import checkpoint as ckpt
    from efficient_tts_tpu_torch.utils import config as config_mod

    with open(os.path.join(out_dir, "paths.json")) as f:
        paths = json.load(f)
    writes = {"config": 0, "checkpoint": 0}
    real_dump, real_save = config_mod.dump_config, ckpt.save_checkpoint

    def dump(*a, **k):
        writes["config"] += 1
        return real_dump(*a, **k)

    def save(*a, **k):
        writes["checkpoint"] += 1
        return real_save(*a, **k)

    config_mod.dump_config, ckpt.save_checkpoint = dump, save
    dist_args = ["--coordinator", url, "--num_processes", str(world), "--process_id", str(rank), "--use_cpu"]
    try:
        t = train.main(["--config", paths["cnn"], "--train_fid_scp", paths["train"], "--dev_fid_scp", paths["dev"],
                        "--outdir", paths["train_out"], *dist_args])
        out["cli_train/loss1"] = np.float64(t.metrics_log[0]["loss"])
        out["cli_train/losses"] = np.array([e["loss"] for e in t.metrics_log])
        out["cli_train/data_extent"] = np.array(t.mesh.shape["data"])
        out.update({f"cli_train/params/{k}": v.numpy() for k, v in t.state["params"].state_dict().items()})
        v = train_vocoder.main(["--wav_scp", paths["wav_scp"], "--dev_wav_scp", paths["wav_scp"], "--outdir",
                                paths["voc_out"], "--config", paths["voc"], "--batch_size", "2",
                                "--train_max_steps", "2", "--save_interval_steps", "2", "--eval_interval_steps", "2",
                                "--log_interval_steps", "1", *dist_args])
        out["cli_voc/g_loss1"] = np.float64(v.metrics_log[0]["g_loss"])
        out["cli_voc/data_path"] = np.array(v.data_path)
        out["cli_voc/evals"] = np.array(len(v.eval_log))
        digest = hashlib.sha256()
        for side in ("gen", "disc"):
            for t in v.state[side]["params"].state_dict().values():
                digest.update(t.numpy().tobytes())
        out["cli_voc/params_sha256"] = np.array(digest.hexdigest())
        if rank == 0:
            # a V1-discriminator checkpoint is about 0.9 GB: map it, read what
            # the test checks, then free the disk
            saved = torch.load(ckpt.latest_checkpoint(paths["voc_out"]), mmap=True, weights_only=True)
            out["cli_voc/saved_step"] = np.array(saved["step"])
            out["cli_voc/saved_keys"] = np.array(sorted(saved))
            shutil.rmtree(paths["voc_out"])
    finally:
        config_mod.dump_config, ckpt.save_checkpoint = real_dump, real_save
    out["cli/writes"] = np.array([writes["config"], writes["checkpoint"]])


def one_process(out):
    from efficient_tts_tpu_torch.bin import train, train_vocoder
    from efficient_tts_tpu_torch.train import checkpoint as ckpt
    from efficient_tts_tpu_torch.train.efts_train_step import make_train_step
    from efficient_tts_tpu_torch.train.hifigan_train_step import make_gan_train_step
    from efficient_tts_tpu_torch.train.optim import HiFiGANAdam, optimizer_from_dict
    from efficient_tts_tpu_torch.train.state import create_state

    for key, cfg in (("cnn", CNN_CFG), ("tr", TR_CFG)):
        _, model, _ = acoustic(cfg)
        tx = optimizer_from_dict(optimizer_config())
        state, step = create_state(model, tx), make_train_step(cfg, tx, device="cpu")
        for i in (1, 2):
            state, m = step(state, batch())
            out[f"{key}/m{i}"] = np.array([float(m[k]) for k in METRICS], np.float64)
            record_acoustic(out, key, cfg, ckpt._saved(state), i)
    tx = HiFiGANAdam(lr=GAN_LR)
    state = gan_state_whole(tx)
    state, m = make_gan_train_step(VOC_CFG, tx, tx, device="cpu")(state, gan_batch())
    out["gan/m1"] = np.array([float(m[k]) for k in GAN_METRICS], np.float64)
    mu = {side: state[side]["opt_state"]["mu"] for side in ("gen", "disc")}
    out.update({f"gan/p1/{k}": v for k, v in gan_leaves(compat.gan_state_to_jax(state)).items()})
    out.update({f"gan/mu1/{k}": v for k, v in gan_leaves(compat.gan_state_to_jax(state, grads=mu)).items()})
    with open(os.path.join(sys.argv[5], "paths.json")) as f:
        paths = json.load(f)
    t = train.main(["--config", paths["cnn"], "--train_fid_scp", paths["train"], "--outdir", paths["one_train_out"],
                    "--use_cpu"])
    out["cli_train/loss1"] = np.float64(t.metrics_log[0]["loss"])
    v = train_vocoder.main(["--wav_scp", paths["wav_scp"], "--outdir", paths["one_voc_out"], "--config", paths["voc"],
                            "--batch_size", "2", "--train_max_steps", "1", "--device_corpus", "off", "--use_cpu"])
    out["cli_voc/g_loss1"] = np.float64(v.metrics_log[0]["g_loss"])
    shutil.rmtree(paths["one_voc_out"])


def dropout_masks(out, mesh):
    """The mask of this rank's dropout generator on a ones tensor."""
    from efficient_tts_tpu_torch.nn.layers import dropout
    from efficient_tts_tpu_torch.parallel import data_seed

    gen = torch.Generator().manual_seed(data_seed(7, mesh))
    out["dropout_mask"] = (dropout(torch.ones(4, 16, 8), 0.5, gen, False) > 0).numpy()


def timed(phases):
    """Run the (name, callable) phases in order, printing each one's wall
    time (the rank's log shows where the budget went)."""
    for name, run in phases:
        t = time.perf_counter()
        run()
        print(f"{name}: {time.perf_counter() - t:.1f} s", flush=True)


def main():
    task, rank, world, url, out_dir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
    torch.set_num_threads(1)
    import torch.distributed as dist

    from efficient_tts_tpu_torch.parallel import initialize_multihost, make_mesh
    from efficient_tts_tpu_torch.utils import plotting

    # the trainers' eval images are drawn as without matplotlib: no test here reads them
    plotting.available = lambda: False

    out = {}
    if task == "one":
        timed([("one_process", lambda: one_process(out))])
        np.savez(os.path.join(out_dir, f"{task}.rank{rank}.npz"), **out)
        return
    initialize_multihost(url, world, rank, device="cpu")
    if task == "world2":
        meshes = {"dp": make_mesh(2, 1), "tp": make_mesh(1, 2)}
        phases = [(f"cnn_{mode}", lambda mode=mode, sp=sp: train_mode(out, f"cnn_{mode}", CNN_CFG,
                                                                        meshes["tp" if sp else mode], sp=sp))
                  for mode, sp in (("dp", False), ("tp", False), ("sp", True))]
        phases.append(("cnn_dp_accum2", lambda: train_mode(out, "cnn_dp_accum2", CNN_CFG, meshes["dp"], accum=2)))
        phases += [(f"cnn_{mode}", lambda mode=mode, cfg=cfg, accum=accum: train_mode(
            out, f"cnn_{mode}", cfg, meshes["dp"], accum=accum, steps=1)) for mode, (cfg, accum) in DP_VARIANTS.items()]
        phases += [(f"tr_{mode}", lambda mode=mode: train_mode(out, f"tr_{mode}", TR_CFG, meshes["tp" if sp else mode],
                                                               sp=sp))
                   for mode, sp in (("dp", False), ("tp", False), ("sp", True))]
        phases += [("gan_dp", lambda: gan_mode(out, "gan_dp", meshes["dp"])),
                   ("tp_gradients", lambda: tp_gradients(out, meshes["tp"])),
                   ("checkpoints", lambda: checkpoints(out, meshes, out_dir, rank)),
                   ("clis", lambda: clis(out, url, world, rank, out_dir))]
    elif task == "world4":
        mesh = make_mesh(2, 2)
        phases = [("cnn_dp+tp", lambda: train_mode(out, "cnn_dp+tp", CNN_CFG, mesh)),
                  ("cnn_dp+sp", lambda: train_mode(out, "cnn_dp+sp", CNN_CFG, mesh, sp=True)),
                  ("tr_dp+sp", lambda: train_mode(out, "tr_dp+sp", TR_CFG, mesh, sp=True)),
                  ("gan_dp+tp", lambda: gan_mode(out, "gan_dp+tp", mesh)),
                  ("cnn_dropout", lambda: train_mode(out, "cnn_dropout", dataclasses.replace(CNN_CFG, dropout_rate=0.1),
                                                     mesh, dropout_seed=5)),
                  ("dropout_masks", lambda: dropout_masks(out, mesh))]
    else:
        raise SystemExit(f"unknown task {task!r}")
    timed(phases)
    np.savez(os.path.join(out_dir, f"{task}.rank{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
