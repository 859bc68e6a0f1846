"""12-bit CT packing for the host→device link (planar layout).

CT voxels span [-2048, 2047] HU — 12 bits.  Packing two voxels into three
bytes cuts host→device transfer bytes by 25% vs int16.

Layout matters: byte-interleaved packing needs stride-3 gathers on
device.  We use a *planar* layout instead — the flat
volume is split into halves (v0 = first half, v1 = second half) and three
contiguous byte planes are shipped:

  plane0 = v0 & 0xFF
  plane1 = (v0 >> 8) | ((v1 & 0xF) << 4)
  plane2 = v1 >> 4

so the device unpack is three contiguous slices + a concat — no shuffles.
Lossless for any HU in range (clipped first, matching the −2048 background
the preprocessing assigns anyway, ``dataset.py:70``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

OFFSET = 2048

# The deployment/bench transport window (== ops.preprocess.WINDOW, pinned by
# a test).  Every consumer of the raw CT on device first clips to this HU
# window (``fused_preprocess``), and both emphysema thresholds (−950 train
# LAA, −910 inference ess) lie strictly inside it, so clamping on the host
# BEFORE packing changes nothing downstream: window rescale, standardize
# stats, and the ``raw < threshold`` mask comparisons are all invariant
# under clip(hu, −1150, −300).  851 levels fit in 10 bits → 1.25 B/voxel
# vs 1.5 for the full-range 12-bit pack.
WINDOW_LO = -1150
WINDOW_HI = -300


def pack12_host(hu: np.ndarray) -> np.ndarray:
    """(B, ...) int16 HU → (B, 3, N/2) uint8 planes; N (voxels per sample)
    must be even."""
    squeeze = hu.ndim == 1
    flat = hu.reshape(1, -1) if squeeze else hu.reshape(hu.shape[0], -1)
    n = flat.shape[-1]
    assert n % 2 == 0, "voxel count must be even for 12-bit packing"
    # stay in 16-bit: the int32 widening costs ~100x under memory pressure
    # on small-core hosts (identical result: clip-then-offset == the old
    # offset-then-clip for the int16 value range)
    v = (np.clip(flat, -OFFSET, 4095 - OFFSET) + OFFSET).astype(np.uint16)
    v0 = v[:, :n // 2]
    v1 = v[:, n // 2:]
    out = np.empty((flat.shape[0], 3, n // 2), np.uint8)
    out[:, 0] = v0 & 0xFF
    out[:, 1] = ((v0 >> 8) | ((v1 & 0xF) << 4)).astype(np.uint8)
    out[:, 2] = (v1 >> 4).astype(np.uint8)
    return out[0] if squeeze else out


def pack10_host(hu: np.ndarray) -> np.ndarray:
    """(B, ...) int16 HU → (B, N + N/4) uint8 window-domain 10-bit pack.

    Values are clamped to the HU window [−1150, −300] (exact for the whole
    device pipeline — see the module comment) and shifted to [0, 850].
    Planar layout for vector-lane-friendly device unpack: the first N bytes
    are the low 8 bits; the last N/4 bytes hold the 2 high bits of the four
    N/4-sized quarters (quarter k in bits 2k..2k+1) — contiguous slices +
    shifts on device, no interleaved gathers (interleaved byte packing
    costs stride gathers).  N (voxels per sample) must be %4 == 0.
    """
    squeeze = hu.ndim == 1
    flat = hu.reshape(1, -1) if squeeze else hu.reshape(hu.shape[0], -1)
    n = flat.shape[-1]
    assert n % 4 == 0, "voxel count must be divisible by 4 for 10-bit pack"
    q = n // 4
    # stay in 16-bit ops (same memory-pressure rationale as pack12_host)
    v = (np.clip(flat, WINDOW_LO, WINDOW_HI)
         - np.int16(WINDOW_LO)).astype(np.uint16)
    out = np.empty((flat.shape[0], n + q), np.uint8)
    out[:, :n] = v & 0xFF
    hi = (v >> 8).astype(np.uint8)      # values 0..3
    acc = hi[:, :q]
    for k in range(1, 4):
        acc = acc | (hi[:, k * q:(k + 1) * q] << (2 * k))
    out[:, n:] = acc
    return out[0] if squeeze else out


def unpack10_device(packed: jax.Array, out_shape) -> jax.Array:
    """(B, N + N/4) uint8 window-domain pack → (B, *out_shape) float32
    clamped HU (device-side inverse of :func:`pack10_host`)."""
    squeeze = packed.ndim == 1
    if squeeze:
        packed = packed[None]
    n = int(np.prod(out_shape))
    q = n // 4
    lo = packed[:, :n].astype(jnp.int32)
    hi = packed[:, n:].astype(jnp.int32)
    hi_parts = jnp.concatenate(
        [(hi >> (2 * k)) & 3 for k in range(4)], axis=-1)
    flat = lo + (hi_parts << 8) + WINDOW_LO
    out = flat.astype(jnp.float32).reshape(packed.shape[0], *out_shape)
    return out[0] if squeeze else out


# Gate granularity in voxels: smaller blocks ship fewer voxels of
# partially-dead blocks but cost more gather work on the device.
GATE_BLOCK = 128


def pick_gate_block(n_vox: int, candidates=(128, 64)) -> int:
    """Preferred block size whose block count divides the packbits byte
    granularity (``n_vox % (block * 8) == 0``), or 0 when none fits —
    the caller then falls back to the ungated transport.  Candidates are
    ordered by measured bytes-vs-unpack balance (module comment); a
    larger candidate can never pass when a smaller one fails, so the
    list is short."""
    for b in candidates:
        if n_vox % (b * 8) == 0:
            return b
    return 0


def gate_blocks_np(gate: np.ndarray, block: int = GATE_BLOCK) -> np.ndarray:
    """Per-voxel gate (B, ...) bool → per-block any-reduction (B, nblk)."""
    g = gate.reshape(gate.shape[0], -1)
    assert g.shape[1] % block == 0, (g.shape, block)
    return g.reshape(g.shape[0], -1, block).any(-1)


def gated_budget(block_counts, block: int = GATE_BLOCK,
                 multiple: int = 8) -> int:
    """Static stream capacity IN VOXELS for :func:`pack10_gated_host`:
    the max touched-BLOCK count over a cohort, rounded up to ``multiple``
    blocks, times the block size.  A deployment sizes this from its
    population the same way it sizes ``pad_shape``."""
    m = int(np.max(block_counts)) if len(np.atleast_1d(block_counts)) else 1
    nb = max(((m + multiple - 1) // multiple) * multiple, multiple)
    return nb * block


def pack10_gated_host(hu: np.ndarray, gate_blk: np.ndarray, budget: int,
                      block: int = GATE_BLOCK):
    """BLOCK-gated window-domain transport (exact): ship only the
    ``block``-voxel flat blocks whose gate has any live voxel — whole
    blocks travel VERBATIM (window-clamped).

    Exactness: a block is dropped only when every voxel in it is at/below
    the window floor, and every such voxel window-clamps to ``WINDOW_LO``
    — which is precisely what the device reconstructs for dropped blocks.
    The deployment contract sets everything outside the 2x-dilated lung
    to −2048 (reference ``dataset.py:69-70``) and pads with −2048, so at
    real lung occupancies the block gate cuts the dominant upload
    ~35-50%.

    Why BLOCKS and not voxels: a per-voxel gate needs a 14M-element
    data-dependent gather on device.  Block reconstruction is a gather of
    a few thousand *contiguous slices* plus a tiny cumsum, which XLA
    lowers to dynamic slices near memory bandwidth.  Blocks also make
    per-voxel gate planes unnecessary (1 bit per block, not per voxel).

    ``hu``: (B, ...) int16; ``gate_blk``: (B, nblk) bool from
    :func:`gate_blocks_np` over any gate ⊇ ``{hu > WINDOW_LO}``;
    ``budget``: voxel capacity (:func:`gated_budget`), % (4·block) == 0.

    Returns ``(packed, blk_bits)``: the 10-bit packed (B, budget·1.25)
    stream (touched blocks in flat scan order, WINDOW_LO padding) and the
    little-endian packbits of the block gate (B, nblk/8).  Raises
    ``ValueError`` when a sample exceeds the budget (caller falls back to
    the ungated transport or re-sizes the budget)."""
    assert budget % block == 0 and budget % 4 == 0, (budget, block)
    flat = hu.reshape(hu.shape[0], -1)
    n = flat.shape[1]
    assert n % block == 0, (n, block)
    nblk = n // block
    gb = np.asarray(gate_blk, bool).reshape(hu.shape[0], nblk)
    assert nblk % 8 == 0, "block count must be %8 for packbits"
    vals = np.full((flat.shape[0], budget), WINDOW_LO, np.int16)
    for b in range(flat.shape[0]):
        sel = flat[b].reshape(nblk, block)[gb[b]]
        if sel.size > budget:
            raise ValueError(
                f"gated voxel count {sel.size} exceeds budget {budget}")
        vals[b, :sel.size] = sel.ravel()
    blk_bits = np.packbits(gb, axis=-1, bitorder="little")
    return pack10_host(vals), blk_bits


def unpack10_gated_device(packed: jax.Array, blk_bits: jax.Array,
                          out_shape, block: int = GATE_BLOCK) -> jax.Array:
    """Device-side inverse of :func:`pack10_gated_host`: (B, budget·1.25)
    uint8 stream + (B, nblk/8) block-gate bytes → (B, *out_shape) float32
    clamped HU, with WINDOW_LO in dropped blocks (== the window clamp of
    the deployment's −2048 mask-out, so downstream preprocessing is
    bit-equal to the ungated transport).

    The destination block's source index is the exclusive prefix sum of
    the block bits (a cumsum over n/block ≈ tens of thousands, not over
    voxels); reconstruction is one contiguous-slice gather per block."""
    squeeze = packed.ndim == 1
    if squeeze:
        packed, blk_bits = packed[None], blk_bits[None]
    n = int(np.prod(out_shape))
    assert n % block == 0, (out_shape, block)
    nblk = n // block
    budget = packed.shape[-1] * 4 // 5
    nb_budget = budget // block
    stream = _unpack10_flat(packed, budget).reshape(
        packed.shape[0], nb_budget, block)
    bytes_ = blk_bits.astype(jnp.int32)                # (B, nblk/8)
    bits = ((bytes_[..., None] >> jnp.arange(8, dtype=jnp.int32)) & 1
            ).reshape(packed.shape[0], nblk)
    idx = jnp.cumsum(bits, axis=-1) - bits             # exclusive prefix
    blocks = jnp.take_along_axis(
        stream, jnp.clip(idx, 0, nb_budget - 1)[..., None], axis=1)
    flat = jnp.where(bits[..., None] > 0, blocks, jnp.float32(WINDOW_LO))
    out = flat.reshape(packed.shape[0], *out_shape)
    return out[0] if squeeze else out


def _unpack10_flat(packed: jax.Array, n: int) -> jax.Array:
    """(B, n + n/4) uint8 window-domain pack → (B, n) float32 clamped HU."""
    q = n // 4
    lo = packed[:, :n].astype(jnp.int32)
    hi = packed[:, n:].astype(jnp.int32)
    hi_parts = jnp.concatenate(
        [(hi >> (2 * k)) & 3 for k in range(4)], axis=-1)
    return (lo + (hi_parts << 8) + WINDOW_LO).astype(jnp.float32)


def unpack12_device(packed: jax.Array, out_shape) -> jax.Array:
    """(B, 3, N/2) uint8 planes → (B, *out_shape) float32 HU (device-side)."""
    squeeze = packed.ndim == 2
    if squeeze:
        packed = packed[None]
    p = packed.astype(jnp.int32)
    b0, b1, b2 = p[:, 0], p[:, 1], p[:, 2]
    v0 = b0 | ((b1 & 0xF) << 8)
    v1 = (b1 >> 4) | (b2 << 4)
    flat = jnp.concatenate([v0, v1], axis=-1) - OFFSET
    out = flat.astype(jnp.float32).reshape(packed.shape[0], *out_shape)
    return out[0] if squeeze else out
