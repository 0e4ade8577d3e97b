"""Training (counterpart of ``adlm_tpu.train``): the ProtoSeg step and
its phase-wise optimizers."""
