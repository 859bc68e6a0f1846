#!/usr/bin/env python
"""Deployment entry point — Grand-Challenge algorithm contract.

CLI parity with the reference ``processor.py:55-74``: same flags, same
default paths (``/input/images/ct/``, ``/input/images/pulmonary-lobes/``,
``/output``), same output files (including the typo'd
``araseptal-emphysema-score.json``, ``processor.py:77``).
"""
import logging
import warnings
from argparse import ArgumentParser

from bodyct_dram_emph_subtype.utils.cli import enable_compile_cache, parse_size

warnings.filterwarnings("ignore")
logging.basicConfig(level=logging.INFO,
                    format="%(asctime)s [%(levelname)s] %(message)s")


def run_testing_job():
    parser = ArgumentParser()
    parser.add_argument("--ngpus", "--nchips", dest="nchips", default=None,
                        type=int, help="data-parallel width (chips)")
    parser.add_argument("--mesh", default=None, type=str,
                        help="mesh layout, e.g. 'data=2,spatial=2,model=2' "
                             "(overrides --ngpus/--nchips)")
    parser.add_argument("--model_arch", default="med3ddram", type=str)
    parser.add_argument("--workers", default=0, type=int)
    parser.add_argument("--batch_size", default=2, type=int)
    parser.add_argument("--target_size", default=(128, 224, 288),
                        type=parse_size)
    parser.add_argument("--scan_path", default="/input/images/ct/", type=str)
    parser.add_argument("--lobe_path",
                        default="/input/images/pulmonary-lobes/", type=str)
    parser.add_argument("--output_path", default="/output", type=str)
    parser.add_argument("--ckp", default="best.ckpt", type=str,
                        help="torch .ckpt/.pth or converted .npz weights")
    parser.add_argument("--compute_dtype", default="bfloat16",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--device_preprocess", action="store_true",
                        default=True,
                        help="default-on: windowing/standardize/resize/"
                             "ess-mask run fused on the device (exact-"
                             "integer resize index math, so the lesion "
                             "percentages agree with the host torch-parity "
                             "path); scans whose crop exceeds --pad_shape "
                             "fall back per-scan")
    parser.add_argument("--host_preprocess", action="store_true",
                        help="force the strict host torch-parity "
                             "preprocessing path instead of the fused "
                             "device path")
    parser.add_argument("--pad_shape", default=(160, 288, 384),
                        type=parse_size,
                        help="static raw-volume buffer for the device "
                             "preprocess path; larger crops fall back to "
                             "host preprocessing")
    parser.add_argument("--gated_frac", default=0.8, type=float,
                        help="sizes the block-gated CT upload stream as a "
                             "fraction of the --pad_shape buffer; a "
                             "deployment tunes this from its population "
                             "like --pad_shape (overflow falls back "
                             "per-scan to host preprocessing)")
    parser.add_argument("--local_rank", default=0, type=int,
                        help="this argument is not used and should be ignored")
    args = parser.parse_args()
    enable_compile_cache()

    from bodyct_dram_emph_subtype.inference import run_inference

    logging.info("starting the inference.")
    results = run_inference(
        scan_path=args.scan_path, lobe_path=args.lobe_path,
        output_path=args.output_path, model_arch=args.model_arch,
        ckp_path=args.ckp, target_size=tuple(args.target_size),
        batch_size=args.batch_size, workers=args.workers,
        nchips=args.nchips, compute_dtype=args.compute_dtype,
        device_preprocess=args.device_preprocess and not args.host_preprocess,
        pad_shape=tuple(args.pad_shape), gated_frac=args.gated_frac,
        mesh=args.mesh)
    print("results:", results)


if __name__ == "__main__":
    print("Docker start running testing job.")
    run_testing_job()
