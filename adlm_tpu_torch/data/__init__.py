"""Training and eval data of the PyTorch port (counterpart of
``adlm_tpu.data``): class tables, the npy-backed segmentation dataset
and the loader.  These modules import numpy and the port's host C++
library, not ``torch``: the loader's spawned workers import them, and
only ``pipeline.device_prefetch`` imports ``torch``, when it is called."""
