"""Training of the port: optimizer, schedule and the train step
(gaussianformer_tpu/train/)."""
