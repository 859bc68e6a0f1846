#!/usr/bin/env python
"""Training entry point (CLI parity with reference ``train.py:19-113``).

Same flags (``--model_arch --lr --ngpus --target_size --data_path
--train_csv --valid_csv --test_csv --model_path --workers --batch_size
--num_samples --ckp --reload_only_weights --max_epochs``), same behavior:
auto-resume from the newest checkpoint, optional greedy weights-only reload,
every-epoch checkpoints, fit then test.
"""
import logging
from argparse import ArgumentParser

from bodyct_dram_emph_subtype.utils.cli import enable_compile_cache, parse_size
from pathlib import Path


def run_training_job():
    parser = ArgumentParser()
    parser.add_argument("--model_arch", default="med3ddram50", type=str)
    parser.add_argument("--lr", "--learning-rate", default=0.0001, type=float)
    parser.add_argument("--ngpus", "--nchips", dest="nchips", default=None,
                        type=int, help="data-parallel width (chips)")
    parser.add_argument("--mesh", default=None, type=str,
                        help="mesh layout, e.g. 'data=2,spatial=2,model=2': "
                             "shard batch over data, volume H over spatial "
                             "(halo-exchanged convs), conv channels over "
                             "model (tensor parallel). Overrides --ngpus")
    # --momentum/--weight_decay are accepted for reference-CLI
    # compatibility but are NOT consumed: the reference constructs plain
    # Adam(lr) and ignores both too (``models.py:685-698``).  Passing a
    # non-default value warns instead of silently implying support.
    parser.add_argument("--momentum", default=None, type=float,
                        help="ignored (reference parity: Adam uses lr only)")
    parser.add_argument("--reload_only_weights", default=1, type=int)
    parser.add_argument("--weight_decay", default=None, type=float,
                        help="ignored (reference parity: Adam uses lr only)")
    parser.add_argument("--ckp", type=str, default=None)
    parser.add_argument("--target_size", default=(128, 224, 288),
                        type=parse_size)
    parser.add_argument("--data_path", default="./COPDGene_cache/", type=str)
    parser.add_argument("--train_csv", default="./COPDGene_cache/merged.csv",
                        type=str)
    parser.add_argument("--valid_csv", default="./COPDGene_cache/merged.csv",
                        type=str)
    parser.add_argument("--test_csv", default="./COPDGene_cache/merged.csv",
                        type=str)
    parser.add_argument("--model_path", default="./models/", type=str)
    parser.add_argument("--workers", default=2, type=int)
    parser.add_argument("--batch_size", default=1, type=int)
    parser.add_argument("--num_samples", default=128, type=int)
    parser.add_argument("--max_epochs", default=120, type=int)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--compute_dtype", default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--input_pipeline", default="host",
                        choices=["host", "device"],
                        help="device: raw int16 volumes, fused preprocess on "
                             "the device")
    parser.add_argument("--pad_shape", default=None, type=parse_size,
                        help="static padded buffer for --input_pipeline=device")
    parser.add_argument("--multihost", action="store_true",
                        help="initialize jax.distributed for multi-host runs")
    parser.add_argument("--profile", action="store_true",
                        help="jax.profiler trace of the first epoch")
    parser.add_argument("--debug_nans", action="store_true")
    parser.add_argument("--remat", default="all", type=str,
                        help="activation-checkpoint scopes: 'all', 'none', "
                             "or a comma list from layer1..layer4,decoder "
                             "(selective remat trades device memory for "
                             "less backward recompute)")
    parser.add_argument("--noise_rng", default="threefry",
                        choices=["threefry", "rbg"],
                        help="augmentation noise source: per-sample threefry"
                             " (stream-stable) or one batched RngBitGenerator"
                             " draw")
    parser.add_argument("--grad_accum", default=1, type=int,
                        help="gradient-accumulation microbatches per step "
                             "(reg strategy): batch_size stays the "
                             "effective batch but the compiled program "
                             "holds only batch_size/grad_accum samples — "
                             "scales batch past what fits in device memory")
    parser.add_argument("--local_rank", default=0, type=int,
                        help="this argument is not used and should be ignored")
    args = parser.parse_args()
    enable_compile_cache()

    if args.momentum is not None or args.weight_decay is not None:
        logging.warning("--momentum/--weight_decay are ignored: the "
                        "optimizer is Adam(lr) exactly like the reference "
                        "(models.py:685-698)")

    if args.multihost:
        import jax
        jax.distributed.initialize()

    from bodyct_dram_emph_subtype.train import (SubtypeTrainer,
                                                    TrainerConfig)

    config = TrainerConfig(
        model_arch=args.model_arch, lr=args.lr, max_epochs=args.max_epochs,
        batch_size=args.batch_size, num_samples=args.num_samples,
        target_size=tuple(args.target_size), workers=args.workers,
        data_path=args.data_path, train_csv=args.train_csv,
        valid_csv=args.valid_csv, test_csv=args.test_csv,
        model_path=args.model_path, nchips=args.nchips, seed=args.seed,
        compute_dtype=args.compute_dtype, profile=args.profile,
        debug_nans=args.debug_nans, input_pipeline=args.input_pipeline,
        pad_shape=args.pad_shape,
        mesh=args.mesh, remat=args.remat, noise_rng=args.noise_rng,
        grad_accum=args.grad_accum)
    config.exp_path.mkdir(parents=True, exist_ok=True)
    logging.basicConfig(
        level=logging.DEBUG,
        format="%(asctime)s [%(levelname)s] %(message)s",
        handlers=[logging.FileHandler(config.exp_path / "debug.log"),
                  logging.StreamHandler()])

    trainer = SubtypeTrainer(config)
    trainer.init_state()
    trainer.setup_checkpointing()
    # auto-resume: explicit --ckp beats newest (train.py:77-91)
    trainer.try_resume(reload_only_weights=bool(args.reload_only_weights),
                       ckp=args.ckp)
    trainer.fit()
    # test with the best (lowest train-loss) checkpoint, like the
    # reference's trainer.test(ckpt_path='best')
    best_epoch = trainer.restore_best()
    trainer.evaluate("test", epoch=best_epoch)


if __name__ == "__main__":
    print("Running training job.")
    run_training_job()
