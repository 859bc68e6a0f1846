"""3-D ResNet model zoo: dilated encoder + U-Net decoder + task heads.

Parity targets:
- ``ResNetSegCls``  (``med3d.py:187-285``) — dense logits per task + global
  average-pooled classification logits;
- ``ResNetSegReg``  (``med3d.py:288-388``) — sigmoid dense maps + lung-masked
  lesion fractions (the dRAM model);
- ``ResNet``        (``med3d.py:427-501``) — plain classifier baseline.

Architecture (all variants): conv1 k7 s2 → maxpool k3 s2 → layer1 (64, s1)
→ layer2 (128, s2) → layer3 (256, s1, dil 2) → layer4 (512, s1, dil 4); the
Seg variants add us1 (x2 up + concat layer1 + 2 convs), us2 (x2 up + concat
stem + 2 convs), us3 (conv 64→32) and per-task 1x1x1 heads at 1/2 input
resolution.

Layout is NDHWC (channels-last); inputs are (B, D, H, W, 1) and lung masks
(B, D, H, W, 1).  Each stage runs under a ``jax.named_scope`` (stem,
maxpool, layer1..layer4, us1..us3, heads, masked_pool), which names its
operations in profiler traces (``tools/profile_sites.py``).
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Type

import jax
import jax.numpy as jnp

from ..ops.masked_pool import lung_masked_fraction
from .blocks import (
    BasicBlock,
    NormWrapper,
    UpsampleConvBlock,
    batch_to_space_3d,
    conv3d,
    max_pool_3d_k3s2p1,
    space_to_batch_3d,
    stem_conv,
)
from .layers import Module, Scope, module, relu

Dtype = Any


def remat_scopes(remat) -> frozenset:
    """Normalise the ``remat`` model attribute into a set of scopes.

    ``True``/"all" checkpoints every residual block and decoder stage;
    ``False``/``None``/"none" nothing; a comma string selects scopes from
    {layer1..layer4, decoder} — e.g. ``"layer1,layer2,decoder"`` recomputes
    only the large stem-/half-resolution activations and keeps the
    FLOP-heavy, small-activation layer3/4 in device memory (selective
    checkpointing: trade the least recompute for the most memory)."""
    if remat is True or remat == "all":
        return frozenset({"layer1", "layer2", "layer3", "layer4", "decoder"})
    if not remat or remat == "none":
        return frozenset()
    return frozenset(s.strip() for s in str(remat).split(",") if s.strip())


@module
class _Trunk(Module):
    """Shared encoder trunk; returns (stem, layer1, layer4) activations.

    ``remat`` checkpoints residual blocks (``jax.checkpoint``) so the
    backward pass recomputes block activations instead of keeping them in
    device memory.  Accepts the selective-scope forms of
    :func:`remat_scopes`."""
    block: Type[Module]
    layers: Sequence[int]
    dtype: Optional[Dtype] = None
    remat: Any = False
    shortcut_type: str = "A"

    def __call__(self, s: Scope, x, train: bool):
        with jax.named_scope("stem"):
            x = stem_conv(s.child("conv1"), x, 64, dtype=self.dtype)
            x = relu(NormWrapper(dtype=self.dtype)(s.child("bn1"), x, train))
            with jax.named_scope("maxpool"):
                xp = max_pool_3d_k3s2p1(x)                # /4
        x1 = self._layer(s, xp, 64, self.layers[0], 1, 1, "layer1", train)
        x2 = self._layer(s, x1, 128, self.layers[1], 2, 1, "layer2", train)
        x3 = self._layer(s, x2, 256, self.layers[2], 1, 2, "layer3", train)
        x4 = self._layer(s, x3, 512, self.layers[3], 1, 4, "layer4", train)
        return x, x1, x4

    def _layer(self, s: Scope, x, planes, blocks, stride, dilation, name,
               train):
        remat = name in remat_scopes(self.remat)
        exp = self.block.expansion
        # Dilated layers run ENTIRELY in the space-to-batch domain when the
        # spatial dims divide the dilation: one pack/unpack for the whole
        # layer instead of per conv.  Exact because every per-block op is
        # sub-grid-local: stride-1 convs couple only same-residue voxels,
        # BN statistics reduce over the same global voxel set (batch-
        # folded), ReLU/residual/shortcut-pad/1x1-convs are pointwise.
        # Non-divisible shapes keep the per-conv lowering (whole-layer
        # zero-padding would leak non-zero pad values between stacked
        # convs).
        packed = (dilation > 1 and stride == 1
                  and all(n % dilation == 0 for n in x.shape[1:4]))
        eff_dil = 1 if packed else dilation
        with jax.named_scope(name):
            if packed:
                x = space_to_batch_3d(x, dilation)
            for i in range(blocks):
                downsample = i == 0 and (stride != 1
                                         or x.shape[-1] != planes * exp)
                block = self.block(
                    planes, stride if i == 0 else 1, eff_dil,
                    use_downsample=downsample, dtype=self.dtype,
                    shortcut_type=self.shortcut_type)
                sub = s.child(f"{name}_{i}")
                x = (sub.checkpointed(block, x, train=train) if remat
                     else block(sub, x, train))
            if packed:
                x = batch_to_space_3d(x, dilation)
        return x


@module
class _Decoder(Module):
    """U-Net-ish decoder: us1/us2/us3 (``med3d.py:215-229``)."""
    dtype: Optional[Dtype] = None
    remat: Any = False

    def __call__(self, s: Scope, x4, x1, stem, train: bool):
        up = UpsampleConvBlock((64, 64), dtype=self.dtype)
        remat = "decoder" in remat_scopes(self.remat)

        def stage(name, x, cats):
            sub = s.child(name)
            with jax.named_scope(name):
                if remat:
                    return sub.checkpointed(up, x, cats, train=train)
                return up(sub, x, cats, train)

        xup1 = stage("us1", x4, x1)
        xup2 = stage("us2", xup1, stem)
        with jax.named_scope("us3"):
            x = conv3d(s.child("us3_conv"), xup2, 32, 3, bias=True,
                       dtype=self.dtype)
            return relu(NormWrapper(dtype=self.dtype)(s.child("us3_bn"), x,
                                                      train))


@module
class ResNetSegCls(Module):
    """Classification variant (``med3d.py:187-285``): per-task dense logits
    + globally average-pooled classification logits."""
    block: Type[Module] = BasicBlock
    layers: Sequence[int] = (3, 4, 6, 3)
    n_classes: Sequence[int] = (6, 3)
    dtype: Optional[Dtype] = None
    remat: Any = False
    shortcut_type: str = "A"

    def __call__(self, s: Scope, x, lungs=None, train: bool = False):
        stem, x1, x4 = _Trunk(self.block, self.layers, self.dtype,
                              self.remat, self.shortcut_type)(
                                  s.child("trunk"), x, train)
        xup3 = _Decoder(self.dtype, self.remat)(s.child("decoder"), x4, x1,
                                                stem, train)
        with jax.named_scope("heads"):
            dense_outs = [conv3d(s.child(f"fc{i}"), xup3, n, 1, bias=True,
                                 dtype=self.dtype)
                          for i, n in enumerate(self.n_classes)]
            cls_outs = [jnp.mean(d.astype(jnp.float32), axis=(1, 2, 3))
                        for d in dense_outs]
        return dense_outs, cls_outs


@module
class ResNetSegReg(Module):
    """dRAM regression variant (``med3d.py:288-388``): sigmoid dense maps +
    lung-masked lesion fractions (CLE, PSE)."""
    block: Type[Module] = BasicBlock
    layers: Sequence[int] = (3, 4, 6, 3)
    dtype: Optional[Dtype] = None
    remat: Any = False
    shortcut_type: str = "A"

    def __call__(self, s: Scope, x, lungs=None, train: bool = False):
        stem, x1, x4 = _Trunk(self.block, self.layers, self.dtype,
                              self.remat, self.shortcut_type)(
                                  s.child("trunk"), x, train)
        xup3 = _Decoder(self.dtype, self.remat)(s.child("decoder"), x4, x1,
                                                stem, train)
        with jax.named_scope("heads"):
            dense_outs = [
                jax.nn.sigmoid(conv3d(s.child(f"fc{i}"), xup3, 1, 1,
                                      bias=True, dtype=self.dtype)
                               .astype(jnp.float32))
                for i in range(2)]
            if lungs is None:
                lungs = jnp.ones(x.shape[:1] + dense_outs[0].shape[1:4]
                                 + (1,), jnp.float32)
            with jax.named_scope("masked_pool"):
                reg_outs = [lung_masked_fraction(d, lungs)[:, 0]
                            for d in dense_outs]
        return dense_outs, reg_outs


@module
class ResNet(Module):
    """Plain classifier baseline (``med3d.py:427-501``): trunk + 1x1x1 conv
    head + global average pool; returns (logits, dense_predictions)."""
    block: Type[Module] = BasicBlock
    layers: Sequence[int] = (3, 4, 6, 3)
    n_classes: int = 6
    dtype: Optional[Dtype] = None
    remat: Any = False
    shortcut_type: str = "A"

    def __call__(self, s: Scope, x, train: bool = False):
        _, _, x4 = _Trunk(self.block, self.layers, self.dtype, self.remat,
                          self.shortcut_type)(s.child("trunk"), x, train)
        dense = conv3d(s.child("fc"), x4, self.n_classes, 1, bias=True,
                       dtype=self.dtype)
        logits = jnp.mean(dense.astype(jnp.float32), axis=(1, 2, 3))
        return logits, dense
