"""HTTP TTS server around a checkpoint (counterpart of `efficient_tts_tpu/bin/serve.py`).

    python -m efficient_tts_tpu_torch.bin.serve --checkpoint exp/checkpoint-100000steps --port 8080
    python -m efficient_tts_tpu_torch.bin.serve --random_init --port 8080   # smoke / demo mode

Loads the acoustic model (the port's checkpoint with the `config.yml`
beside it, or seeded random EFTS-CNN weights with 148 symbols) and the
vocoder, runs the engine's warmup over the bucket grid and serves

    POST /synthesize {"text": "..."}          -> audio/wav (22050 Hz PCM_16)
    POST /synthesize_stream {"text": "..."}   -> chunked raw PCM_16
    GET  /healthz, GET /stats

with dynamic micro-batching (concurrent requests share one batch on the
card). Runs on the card; `--use_cpu` runs on the CPU, and without a card
and without it the server raises. SIGTERM stops it cleanly.

Over N cards, one process per card (data parallel, the batch of each
micro-batch split over the ranks):

    torchrun --nproc_per_node N -m efficient_tts_tpu_torch.bin.serve --data_parallel N --random_init

Rank 0 binds the HTTP server and runs the batcher; it broadcasts each
micro-batch to the other ranks, which dispatch it too (`TTSEngine.lead` /
`follow`), and at shutdown the stop flag, on which they exit.
`--coordinator_address`, `--num_processes` and `--process_id` replace
torchrun's environment.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import threading

TORCHRUN = "torchrun --nproc_per_node {n} -m efficient_tts_tpu_torch.bin.serve --data_parallel {n} ..."


def get_parser():
    p = argparse.ArgumentParser(description="EfficientTTS HTTP server on the card")
    p.add_argument("--checkpoint", default=None, help="acoustic model checkpoint (config.yml beside it)")
    p.add_argument("--vocoder_checkpoint", default=None,
                   help="reference HiFi-GAN generator file, or a BigVGAN one with its config.json beside it")
    p.add_argument("--random_init", action="store_true", help="serve random weights (smoke tests, benches)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max_batch", type=int, default=16)
    p.add_argument("--max_wait_ms", type=float, default=10.0)
    p.add_argument("--max_queue", type=int, default=256,
                   help="admission bound on pending requests; beyond it submits get 503 + Retry-After "
                   "(0 = unbounded)")
    p.add_argument("--deadline_ms", type=float, default=10000.0,
                   help="queue-wait deadline; admitted requests that age past it are shed with 503 "
                   "(0 = no deadline)")
    p.add_argument("--bf16", action="store_true", help="serve the decoder and vocoder in bfloat16")
    p.add_argument("--use_cpu", action="store_true", help="run on the CPU (the default is the card)")
    p.add_argument("--no_warmup", action="store_true")
    p.add_argument("--data_parallel", type=int, default=0,
                   help="split serving micro-batches over N ranks, one process per card, launched by torchrun "
                   "(0 = one process; must divide --max_batch)")
    p.add_argument("--coordinator_address", default=None,
                   help="with --data_parallel: the rendezvous (host:port or a file:// URL) instead of torchrun's "
                   "environment; needs --num_processes and --process_id")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--dist_backend", default=None, choices=("nccl", "gloo"),
                   help="with --data_parallel: the collectives' backend (default nccl on the card, gloo on the CPU)")
    p.add_argument("--device_index", type=int, default=None,
                   help="with --data_parallel: this rank's card (default LOCAL_RANK); ranks that share one card "
                   "must say so here, and need --dist_backend gloo")
    return p


def init_ranks(args):
    """The mesh of --data_parallel N ranks ([N, 1]) and this rank's device, or
    (None, the one device) without it."""
    import torch

    from efficient_tts_tpu_torch.parallel import initialize_multihost, make_mesh, rank_device
    from efficient_tts_tpu_torch.utils.device import resolve_device

    device = "cpu" if args.use_cpu else "cuda"
    n = args.data_parallel
    if not n:
        return None, resolve_device(device)
    if args.max_batch % n:
        raise SystemExit(f"--max_batch {args.max_batch} not divisible by --data_parallel {n}")
    world = args.num_processes if args.coordinator_address else int(os.environ.get("WORLD_SIZE", 1))
    if world != n:
        raise SystemExit(f"--data_parallel {n} needs a world of {n} processes, not {world}: launch it as "
                         + TORCHRUN.format(n=n))
    dev = rank_device(device, args.device_index)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    initialize_multihost(args.coordinator_address, args.num_processes, args.process_id, backend=args.dist_backend,
                         device=device)
    return make_mesh(data=n, model=1), dev


def build_engine(args, mesh=None, device=None):
    import torch

    from efficient_tts_tpu_torch import compat, init
    from efficient_tts_tpu_torch.bin.inference import load_acoustic_model, load_vocoder
    from efficient_tts_tpu_torch.models.efficient_tts import EftsCNNConfig
    from efficient_tts_tpu_torch.models.hifigan import HiFiGANConfig
    from efficient_tts_tpu_torch.serve import TTSEngine
    from efficient_tts_tpu_torch.text import load_phone_vocab
    from efficient_tts_tpu_torch.utils.device import resolve_device

    device = resolve_device(device or ("cpu" if args.use_cpu else "cuda"))
    phone_vocab = None
    if args.random_init:
        cfg = EftsCNNConfig(num_symbols=148, dropout_rate=0.0, use_masking=True)
        voc_cfg = HiFiGANConfig()  # random-init mode keeps the defaults
        model = compat.efts_cnn_from_jax(init.init_efts(0, cfg), cfg, device=device)
        voc = compat.hifigan_generator_from_jax(init.init_generator(1, voc_cfg), voc_cfg, device=device)
    else:
        if not args.checkpoint:
            raise SystemExit("--checkpoint required (or pass --random_init)")
        model, config = load_acoustic_model(args.checkpoint, device)
        voc = load_vocoder(args.vocoder_checkpoint, device)
        ds_params = dict(config.get("dataset_params", {}))
        if ds_params.get("use_phnseq"):
            phone_vocab = load_phone_vocab(ds_params["phnset_path"])
    return TTSEngine(model, voc, device=device, max_batch=args.max_batch,
                     compute_dtype=torch.bfloat16 if args.bf16 else None, phone_vocab=phone_vocab, mesh=mesh)


def main(argv=None):
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from efficient_tts_tpu_torch.parallel import is_primary
    from efficient_tts_tpu_torch.serve import make_http_server, serve_forever

    mesh, device = init_ranks(args)
    try:
        engine = build_engine(args, mesh, device)
        if not args.no_warmup:
            logging.info("warming up the bucket grid...")
            engine.warmup()  # every rank: its dispatches are collective
        if not is_primary():
            logging.info("rank %d following %d micro-batches", mesh.rank, engine.follow())
            return
        server = make_http_server(engine, args.host, args.port, max_wait_ms=args.max_wait_ms,
                                  max_queue=args.max_queue or None, deadline_ms=args.deadline_ms or None)
        # SIGTERM: stop serving (from another thread: shutdown waits for serve_forever)
        signal.signal(signal.SIGTERM, lambda *_: threading.Thread(target=server.shutdown).start())
        if mesh is not None:
            engine.lead()
        try:
            serve_forever(server)
        finally:
            engine.release_followers()
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
