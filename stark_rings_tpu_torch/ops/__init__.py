"""Ring-multiply engines and their kernels (counterpart of
``stark_rings_tpu/ops``)."""
