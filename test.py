#!/usr/bin/env python
"""Evaluation entry point (CLI parity with reference ``test.py:18-87``):
load a specific epoch checkpoint (or torch ``.ckpt``) and run the test
split, emitting confusion matrices, CSVs, and heatmap tiles."""
import logging
from argparse import ArgumentParser

from bodyct_dram_emph_subtype.utils.cli import enable_compile_cache, parse_size
from pathlib import Path


def run_testing_job():
    parser = ArgumentParser()
    parser.add_argument("--model_arch", default="med3d", type=str)
    parser.add_argument("--ngpus", "--nchips", dest="nchips", default=None,
                        type=int)
    parser.add_argument("--ckp", type=str, default=None,
                        help="epoch number, or a torch .ckpt/.pth path")
    parser.add_argument("--data_path", default="./COPDGene_cache/", type=str)
    parser.add_argument("--train_csv", default="./COPDGene_cache/merged.csv",
                        type=str)
    parser.add_argument("--valid_csv", default="./COPDGene_cache/merged.csv",
                        type=str)
    parser.add_argument("--test_csv", default="./COPDGene_cache/merged.csv",
                        type=str)
    parser.add_argument("--model_path", default="./models/", type=str)
    parser.add_argument("--target_size", default=(128, 224, 288),
                        type=parse_size)
    parser.add_argument("--workers", default=2, type=int)
    parser.add_argument("--batch_size", default=4, type=int)
    parser.add_argument("--compute_dtype", default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--local_rank", default=0, type=int,
                        help="this argument is not used and should be ignored")
    args = parser.parse_args()
    enable_compile_cache()

    from bodyct_dram_emph_subtype.train import (SubtypeTrainer,
                                                    TrainerConfig)

    config = TrainerConfig(
        model_arch=args.model_arch, batch_size=args.batch_size,
        target_size=tuple(args.target_size), workers=args.workers,
        data_path=args.data_path, train_csv=args.train_csv,
        valid_csv=args.valid_csv, test_csv=args.test_csv,
        model_path=args.model_path, nchips=args.nchips,
        compute_dtype=args.compute_dtype)
    config.exp_path.mkdir(parents=True, exist_ok=True)
    logging.basicConfig(
        level=logging.DEBUG,
        format="%(asctime)s [%(levelname)s] %(message)s",
        handlers=[logging.FileHandler(config.exp_path / "debug.log"),
                  logging.StreamHandler()])

    trainer = SubtypeTrainer(config)
    trainer.init_state()
    trainer.setup_checkpointing()
    epoch = 0
    if args.ckp is not None and Path(args.ckp).suffix in (".ckpt", ".pth",
                                                          ".npz"):
        trainer.try_resume(ckp=args.ckp)
    elif args.ckp is not None:
        state, extras, epoch = trainer.ckpt.restore(trainer.state,
                                                    epoch=int(args.ckp))
        trainer.state = state
    else:
        trainer.try_resume(reload_only_weights=True)
        epoch = trainer.ckpt.latest_epoch() or 0
    trainer.evaluate("test", epoch=epoch)


if __name__ == "__main__":
    print("Running testing job.")
    run_testing_job()
