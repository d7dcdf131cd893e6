"""Training on one device (``repro.train``): the data pipeline, AdamW, the
train step with remat and microbatches, and checkpoints."""
