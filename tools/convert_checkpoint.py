#!/usr/bin/env python
"""Checkpoint interop: torch ``.ckpt``/``.pth`` ⇄ framework formats.

- ``--to_npz``: convert a torch Lightning checkpoint (``paper.ckpt``/
  ``best.ckpt`` style, state-dict keys ``model.*``, ``models.py:408``) into a
  flat ``.npz`` of numpy arrays (keeps the torch names; loadable later with
  ``greedy_restore_variables`` without torch installed);
- ``--to_checkpoint``: import a torch checkpoint into a framework
  checkpoint directory (``train/checkpoint.py``) for a given arch (params +
  batch stats, fresh optimizer state).

Usage:
  python tools/convert_checkpoint.py --src best.ckpt --to_npz best.npz
  python tools/convert_checkpoint.py --src best.ckpt --arch med3ddram \
      --to_checkpoint models/subtyping_med3ddram/checkpoints
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", required=True,
                        help="torch .ckpt/.pth checkpoint")
    parser.add_argument("--to_npz", type=str)
    parser.add_argument("--to_checkpoint", type=str)
    parser.add_argument("--arch", default="med3ddram")
    parser.add_argument("--epoch", default=0, type=int)
    args = parser.parse_args()

    from bodyct_dram_emph_subtype.models.torch_import import (
        load_torch_checkpoint)

    state_dict = load_torch_checkpoint(args.src)
    print(f"loaded {len(state_dict)} entries from {args.src}")

    if args.to_npz:
        np.savez_compressed(args.to_npz,
                            **{k: np.asarray(v)
                               for k, v in state_dict.items()})
        print(f"wrote {args.to_npz}")

    if args.to_checkpoint:
        import jax
        import jax.numpy as jnp

        from bodyct_dram_emph_subtype.models import get_model_by_name
        from bodyct_dram_emph_subtype.models.torch_import import (
            convert_state_dict)
        from bodyct_dram_emph_subtype.train import (
            CheckpointManager, TrainState, make_optimizer)

        model = get_model_by_name(args.arch)
        x = jnp.zeros((1, 16, 32, 32, 1), jnp.float32)
        variables = dict(model.init(jax.random.PRNGKey(0), x, x,
                                    train=False))
        variables, report = convert_state_dict(state_dict, variables)
        print("conversion report:", report)
        state = TrainState.create(variables, make_optimizer())
        CheckpointManager(args.to_checkpoint).save(args.epoch, state)
        print(f"wrote checkpoint epoch {args.epoch} under "
              f"{args.to_checkpoint}")


if __name__ == "__main__":
    main()
