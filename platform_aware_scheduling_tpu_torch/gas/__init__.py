"""GPU-aware scheduling (GAS): per-card resource bookkeeping and first-fit
bin-packing, so fractional-GPU pods land on nodes where each card can hold
them (reference gpu-aware-scheduling/README.md:14-19).

The port's copy of ``platform_aware_scheduling_tpu/gas``.  The host layer
keeps the reference's semantics; Filter's batched path runs the bin-pack of
``ops/binpack.py`` over every candidate node at once, on the card as the
CUDA kernel ``csrc/binpack.cu``."""
