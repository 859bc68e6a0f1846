"""JAX emphysema-subtyping framework.

A from-scratch rebuild of the capabilities of DIAGNijmegen/bodyct-dram-emph-subtype:
weakly-supervised Fleischner emphysema severity scoring (CLE 6-way, PSE 3-way) on
chest CT plus dense regression activation maps (dRAM), re-designed for an
accelerator:

- the CPU transform chain of the reference (``intensity_transforms.py`` /
  ``spatial_transforms.py``) becomes fused on-device XLA ops
  (:mod:`bodyct_dram_emph_subtype.ops`);
- the 3D-ResNet model zoo (``med3d.py``) becomes functional modules in
  channels-last
  NDHWC layout (:mod:`bodyct_dram_emph_subtype.models`);
- the Lightning training system (``models.py``) becomes an explicit jitted
  train loop over a ``jax.sharding.Mesh`` with GSPMD data parallelism and
  cross-replica batch-norm (:mod:`bodyct_dram_emph_subtype.train`);
- the deployment processor (``processor.py``) becomes a batched device
  pipeline with the same CLI and output contract
  (:mod:`bodyct_dram_emph_subtype.inference`).
"""

__version__ = "0.1.0"
