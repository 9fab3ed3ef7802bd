"""Losses of the prob configs (gaussianformer_tpu/losses/)."""
