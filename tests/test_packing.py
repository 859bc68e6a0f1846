"""CT packing roundtrips (12-bit full-range, 10-bit window-domain)."""
import numpy as np

import jax.numpy as jnp

from bodyct_dram_emph_subtype.ops.packing import (
    WINDOW_HI, WINDOW_LO, pack10_host, pack12_host, unpack10_device,
    unpack12_device)


def test_pack_unpack_roundtrip(rng):
    hu = rng.randint(-2048, 2048, (3, 8, 10, 12)).astype(np.int16)
    packed = pack12_host(hu)
    assert packed.dtype == np.uint8
    assert packed.size == hu.size * 3 // 2
    out = np.asarray(unpack12_device(jnp.asarray(packed), hu.shape[1:]))
    np.testing.assert_array_equal(out, hu.astype(np.float32))


def test_pack_clips_out_of_range(rng):
    hu = np.asarray([[-3000, 3000, 0, -2048]], np.int16)
    out = np.asarray(unpack12_device(jnp.asarray(pack12_host(hu)), (4,)))
    np.testing.assert_array_equal(out, [[-2048, 2047, 0, -2048]])


def test_pack10_window_matches_preprocess_window():
    # the clamp-before-pack exactness argument relies on the transport
    # window being the preprocessing window
    from bodyct_dram_emph_subtype.ops.preprocess import WINDOW
    assert (float(WINDOW_LO), float(WINDOW_HI)) == WINDOW


def test_pack10_roundtrip_is_window_clamp(rng):
    hu = rng.randint(-2048, 2048, (3, 8, 10, 12)).astype(np.int16)
    packed = pack10_host(hu)
    assert packed.dtype == np.uint8
    assert packed.size == hu.size + hu.size // 4        # 1.25 B/voxel
    out = np.asarray(unpack10_device(jnp.asarray(packed), hu.shape[1:]))
    np.testing.assert_array_equal(
        out, np.clip(hu, WINDOW_LO, WINDOW_HI).astype(np.float32))


def test_pack10_preprocess_equals_raw_preprocess(rng):
    # clamping to the window before packing changes NOTHING the fused
    # preprocess computes: window rescale, standardize stats, and the
    # em/ess threshold masks (−950/−910 both inside the window)
    from bodyct_dram_emph_subtype.ops.preprocess import fused_preprocess
    pad = (8, 12, 16)
    hu = rng.randint(-2048, 500, (2, *pad)).astype(np.int16)
    lung = (rng.rand(2, *pad) > 0.4).astype(np.uint8)
    sizes = np.asarray([[8, 12, 16], [7, 11, 13]], np.int32)
    target = (4, 6, 8)
    for thr in (-950.0, -910.0):
        ref = fused_preprocess(jnp.asarray(hu), jnp.asarray(lung),
                               jnp.asarray(sizes), target_size=target,
                               em_threshold=thr)
        via = fused_preprocess(
            unpack10_device(jnp.asarray(pack10_host(hu)), pad),
            jnp.asarray(lung), jnp.asarray(sizes), target_size=target,
            em_threshold=thr)
        for k in ref:
            np.testing.assert_array_equal(np.asarray(ref[k]),
                                          np.asarray(via[k]))


def test_pack10_gated_roundtrip_equals_ungated(rng):
    """Block-gated transport with the deployment mask-out
    contract (outside the dilated lung == −2048, reference
    ``dataset.py:69-70``) the block stream + block bits reconstruct
    EXACTLY the clamped volume the ungated 10-bit pack ships."""
    from bodyct_dram_emph_subtype.ops.packing import (
        gate_blocks_np, gated_budget, pack10_gated_host,
        unpack10_gated_device)
    shape = (8, 16, 16)                      # 2048 vox → 32 blocks of 64
    block = 64
    hu = rng.randint(-1100, -300, (3, *shape)).astype(np.int16)
    zz, yy, xx = np.mgrid[:shape[0], :shape[1], :shape[2]]
    gate = ((((zz - 4) / 3.4) ** 2 + ((yy - 8) / 6.2) ** 2
             + ((xx - 8) / 6.5) ** 2) < 1)[None].repeat(3, axis=0)
    hu[~gate] = -2048                               # the mask-out contract
    gb = gate_blocks_np(gate.reshape(3, -1), block=block)
    assert 0 < gb.sum() < gb.size, "need a non-trivial block gate"
    budget = gated_budget(gb.sum(-1), block=block, multiple=1)
    packed, blk_bits = pack10_gated_host(hu, gb, budget, block=block)
    assert packed.shape[-1] == budget + budget // 4
    got = np.asarray(unpack10_gated_device(
        jnp.asarray(packed), jnp.asarray(blk_bits), shape, block=block))
    want = np.asarray(unpack10_device(jnp.asarray(pack10_host(hu)), shape))
    np.testing.assert_array_equal(got, want)


def test_pack10_gated_budget_overflow_raises(rng):
    from bodyct_dram_emph_subtype.ops.packing import (
        gate_blocks_np, pack10_gated_host)
    hu = np.full((1, 8, 8, 8), -700, np.int16)
    gb = gate_blocks_np(np.ones((1, 512), bool), block=64)
    import pytest
    with pytest.raises(ValueError):
        pack10_gated_host(hu, gb, budget=256, block=64)


def test_pack10_gated_value_gate_is_exact(rng):
    """The minimal value gate (hu > WINDOW_LO): a block is dropped only
    when EVERY voxel in it sits at/below the window floor — all of which
    reconstruct to the identical clamp — so padding and mask-out drop out
    automatically and in-window values survive exactly."""
    from bodyct_dram_emph_subtype.ops.packing import (
        gate_blocks_np, gated_budget, pack10_gated_host,
        unpack10_gated_device)
    from bodyct_dram_emph_subtype.ops.packing import WINDOW_HI
    hu = rng.randint(-1400, -200, (2, 8, 16, 16)).astype(np.int16)
    hu[:, :3] = -2048                        # fully-dead region → dropped
    block = 128
    gb = gate_blocks_np((hu > WINDOW_LO).reshape(2, -1), block=block)
    budget = gated_budget(gb.sum(-1), block=block, multiple=1)
    packed, bits = pack10_gated_host(hu, gb, budget, block=block)
    got = np.asarray(unpack10_gated_device(
        jnp.asarray(packed), jnp.asarray(bits), (8, 16, 16), block=block))
    np.testing.assert_array_equal(
        got, np.clip(hu, WINDOW_LO, WINDOW_HI).astype(np.float32))


def test_pick_gate_block():
    from bodyct_dram_emph_subtype.ops.packing import pick_gate_block
    assert pick_gate_block(128 * 288 * 384) == 128
    assert pick_gate_block(32 * 56 * 72) == 128
    assert pick_gate_block(64 * 8 * 9) == 64
    assert pick_gate_block(8 * 8 * 9) == 0
