"""Train state + optimizer assembly.

Replaces Lightning's implicit state with an explicit pytree: params,
batch stats, Adam state, step/epoch counters.  The optimizer matches the
reference: Adam (torch defaults: b1=0.9, b2=0.999, eps=1e-8) with an
exponential per-epoch decay γ=0.95 (``models.py:685-698``) — implemented by
passing the epoch's learning rate into the jitted step (no retrace, no
schedule state).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import jax
import jax.numpy as jnp
import optax


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    params: Any
    batch_stats: Any
    opt_state: Any
    step: jax.Array
    epoch: jax.Array

    @classmethod
    def create(cls, variables: Dict[str, Any], tx: optax.GradientTransformation):
        params = variables["params"]
        return cls(params=params,
                   batch_stats=variables.get("batch_stats", {}),
                   opt_state=tx.init(params),
                   step=jnp.zeros((), jnp.int32),
                   epoch=jnp.zeros((), jnp.int32))

    @property
    def variables(self):
        return {"params": self.params, "batch_stats": self.batch_stats}

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def make_optimizer() -> optax.GradientTransformation:
    """Adam core; the learning rate is applied inside the train step so the
    per-epoch exponential decay needs no schedule state."""
    return optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)


def epoch_lr(base_lr: float, epoch: int, gamma: float = 0.95) -> float:
    """torch ``ExponentialLR``: lr * γ^epoch."""
    return base_lr * (gamma ** int(epoch))


def apply_updates(state: TrainState, grads, tx: optax.GradientTransformation,
                  lr) -> "TrainState":
    updates, new_opt_state = tx.update(grads, state.opt_state, state.params)
    updates = jax.tree.map(lambda u: -lr * u, updates)
    new_params = optax.apply_updates(state.params, updates)
    return state.replace(params=new_params, opt_state=new_opt_state,
                         step=state.step + 1)
