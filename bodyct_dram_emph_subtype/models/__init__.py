"""Model zoo (the reference's L4, ``med3d.py``, rebuilt NDHWC in JAX)."""
from .blocks import (
    BasicBlock,
    Bottleneck,
    NormWrapper,
    UpsampleConvBlock,
    conv3d,
    crop_concat,
    downsample_shortcut_a,
    max_pool_3d_k3s2p1,
)
from .registry import (
    get_model_by_name,
    resnet18segcls,
    resnet18segreg,
    resnet34,
    resnet34segcls,
    resnet34segreg,
    resnet50,
    resnet50segcls,
    resnet50segreg,
)
from .resnet3d import ResNet, ResNetSegCls, ResNetSegReg

__all__ = [
    "BasicBlock", "Bottleneck", "NormWrapper", "ResNet", "ResNetSegCls",
    "ResNetSegReg", "UpsampleConvBlock", "conv3d", "crop_concat",
    "downsample_shortcut_a", "get_model_by_name", "max_pool_3d_k3s2p1",
    "resnet18segcls", "resnet18segreg", "resnet34", "resnet34segcls",
    "resnet34segreg", "resnet50", "resnet50segcls", "resnet50segreg",
]
