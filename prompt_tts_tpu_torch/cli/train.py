"""Train the TTS model on PyTorch: ``python -m prompt_tts_tpu_torch.cli.train``.

The port of ``prompt_tts_tpu/cli/train.py``: the reference's flags
(--data_file/--log_dir/--config_file/--ckpt_dir/--batch_size/
--max_seq_length) plus --epochs, --resume, --ema_decay, --bf16,
--eval_every, --log_every, --smoke (the tiny config, or --config_file's,
on synthetic data), --init_from_ref (a warm start from a reference-repo
``ckpt_N.pt``), --remat (activation recomputation), --profile_steps (a
``torch.profiler`` Chrome trace of N steps under ``<log_dir>/trace/``),
--streaming (batches read from the tar as they are needed), --multihost
(data parallelism: one process per GPU under DDP, ``--batch_size`` the
global batch), --per_process_data (with --multihost: each process
collates only its rows), --tp N (with --multihost: tensor parallelism,
the model's Megatron slices over model groups of N ranks, the world laid
out as world/N data ranks x N, ``parallel/tp.py``), --sp M (with
--multihost: sequence parallelism, the UNet's latent time sharded over
seq groups of M ranks, the world laid out as data x N x M,
``parallel/sp.py``) and --device (``cuda`` unless the caller asks for
``cpu``; under --multihost ``cuda:LOCAL_RANK``). Both model families
train: a config with ``prompt_conditioning`` gets prompt crops of
``prompt_frames`` in every batch.  Without a warm start the weights
start from ``train.seed``.

  python -m prompt_tts_tpu_torch.cli.train --data_file codes.tar \\
      --bf16 --ckpt_dir ckpt --ema_decay 0.999
  python -m prompt_tts_tpu_torch.cli.train --data_file codes.tar \\
      --streaming --remat --profile_steps 2
  python -m prompt_tts_tpu_torch.cli.train --smoke --device cpu
  torchrun --nproc_per_node 8 -m prompt_tts_tpu_torch.cli.train \\
      --multihost --data_file codes.tar --bf16 --ckpt_dir ckpt
  torchrun --nproc_per_node 8 -m prompt_tts_tpu_torch.cli.train \\
      --multihost --tp 2 --data_file codes.tar --bf16 --ckpt_dir ckpt
  torchrun --nproc_per_node 8 -m prompt_tts_tpu_torch.cli.train \\
      --multihost --tp 2 --sp 2 --data_file codes.tar --ckpt_dir ckpt

Under --multihost the rendezvous comes from torchrun's environment, or
from ``PTTS_COORDINATOR`` (``host:port``), ``PTTS_NUM_PROCESSES`` and
``PTTS_PROCESS_ID`` set for each process by hand
(``parallel.init_distributed``).
"""

import argparse
import dataclasses
import logging

from prompt_tts_tpu_torch.cli._common import (
    add_parallel_args, check_parallel_flags,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train the TTS diffusion model "
                                            "(PyTorch port).")
    p.add_argument("--data_file", type=str, default=None,
                   help="Processed code tar (generate_codes output).")
    p.add_argument("--log_dir", type=str, default="runs/train",
                   help="JSONL metrics directory.")
    p.add_argument("--config_file", type=str, default=None,
                   help="JSON config (flat reference schema or nested).")
    p.add_argument("--ckpt_dir", type=str, default=None,
                   help="Checkpoint directory.")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--max_seq_length", type=int, default=550)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--resume", action="store_true",
                   help="Restore the latest checkpoint before training.")
    p.add_argument("--init_from_ref", type=str, default=None,
                   help="Warm-start from a reference torch checkpoint "
                        "(ckpt_N.pt from the original repo's train.py), "
                        "converted on the fly; the config must match it.")
    p.add_argument("--ema_decay", type=float, default=None,
                   help="Keep an exponential moving average of the params "
                        "at this decay (e.g. 0.9999), checkpointed.")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (params and moments stay f32).")
    p.add_argument("--eval_every", type=int, default=0,
                   help="Run a deterministic eval pass (Loss/eval) every "
                        "N epochs (0 = never).")
    p.add_argument("--log_every", type=int, default=0,
                   help="Pull loss/grad_norm to the host (a device sync) "
                        "every N steps; 0 = 50 on the card, 1 on the CPU.")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="Capture a torch.profiler trace of N steps into "
                        "<log_dir>/trace (0 = off).")
    p.add_argument("--remat", action="store_true",
                   help="Activation rematerialization "
                        "(torch.utils.checkpoint).")
    p.add_argument("--streaming", action="store_true",
                   help="Stream batches from the tar instead of loading "
                        "the corpus into RAM (large corpora).")
    p.add_argument("--smoke", action="store_true",
                   help="Tiny config on synthetic data (sanity check).")
    p.add_argument("--per_process_data", action="store_true",
                   help="With --multihost: each process loads only its 1/P "
                        "slice of every batch (per-host corpus I/O scales "
                        "down; streaming datasets never read the other "
                        "hosts' rows).")
    add_parallel_args(p, "Data parallelism over processes (one per GPU, "
                         "under torchrun or the PTTS_* variables): "
                         "torch.distributed with DDP, with --tp tensor "
                         "and with --sp sequence parallelism.")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Train; returns the Trainer (its ``global_step``, metrics and
    state)."""
    args = parse_args(argv)
    if args.init_from_ref and args.resume:
        raise SystemExit("--init_from_ref and --resume are mutually "
                         "exclusive (resume restores params itself)")
    check_parallel_flags(args)
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s: %(message)s",
        level=logging.INFO, datefmt="%I:%M:%S",
    )
    import torch

    device = args.device
    if args.multihost:
        from prompt_tts_tpu_torch.parallel import init_distributed
        device = init_distributed(device, backend=args.backend,
                                  n_model=args.tp, n_seq=args.sp)
    try:
        return _train(args, device)
    finally:
        if args.multihost:
            torch.distributed.destroy_process_group()


def _train(args, device):
    import torch
    from prompt_tts_tpu_torch.config import Config, ModelConfig, TrainConfig
    from prompt_tts_tpu_torch.data.dataset import (
        CodeDataset, SyntheticDataset,
    )
    from prompt_tts_tpu_torch.train.loop import Trainer

    if args.config_file:
        config = Config.from_json(args.config_file)
    elif args.smoke:
        config = Config(
            model=ModelConfig(
                block_out_channels=(32, 64, 64, 64), cross_attention_dim=64,
                attention_head_dim=32, text_encoder_layers=1, cmu_seq_len=32,
                sample_size=48, layers_per_block=1, unet_num_heads=4),
            train=TrainConfig(batch_size=8, num_train_epochs=1,
                              learning_rate=1e-3, lr_warmup_steps=0),
        )
    else:
        config = Config()
    train = config.train
    if args.batch_size:
        train = dataclasses.replace(train, batch_size=args.batch_size)
    if args.ema_decay is not None:
        train = dataclasses.replace(train, ema_decay=args.ema_decay)
    config = dataclasses.replace(config, train=train)

    # the prompt family trains on a voice-prompt crop in every batch
    pf = (config.model.prompt_frames if config.model.prompt_conditioning
          else None)
    if args.smoke:
        dataset = SyntheticDataset(
            n=16, frames=config.model.sample_size,
            max_seq_length=config.model.cmu_seq_len, prompt_frames=pf)
    else:
        if not args.data_file:
            raise SystemExit("--data_file is required (or use --smoke)")
        if args.streaming:
            from prompt_tts_tpu_torch.data.streaming import (
                StreamingCodeDataset,
            )
            dataset = StreamingCodeDataset(
                args.data_file, max_seq_length=args.max_seq_length,
                prompt_frames=pf)
        else:
            dataset = CodeDataset(args.data_file,
                                  max_seq_length=args.max_seq_length,
                                  prompt_frames=pf)

    init_state = None
    if args.init_from_ref:
        from prompt_tts_tpu_torch.models.convert import load_reference_state
        init_state = load_reference_state(args.init_from_ref)
        logging.info("warm-starting from converted reference checkpoint %s",
                     args.init_from_ref)

    trainer = Trainer(
        config, dataset, log_dir=args.log_dir, ckpt_dir=args.ckpt_dir,
        device=device, per_process_data=args.per_process_data,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        eval_every=args.eval_every, log_every=args.log_every,
        init_state=init_state, remat=args.remat,
        profile_steps=args.profile_steps)
    if args.resume:
        trainer.restore_latest()
    loss = trainer.train(epochs=args.epochs)
    logging.info("final loss: %f (step %d)", loss, trainer.global_step)
    return trainer


if __name__ == "__main__":
    main()
