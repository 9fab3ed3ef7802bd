"""Losses (gaussianformer_tpu/losses/): occupancy (CE, Lovász, the focal,
dice and scal options), the BCE family and their composition."""
