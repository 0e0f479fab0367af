"""Training of the LM family (PyTorch): AdamW by hand, the train step with
microbatch accumulation, checkpoints in the reference's format, the
fault-tolerant controller.  The pipeline schedule (``train/pipeline.py``)
goes with the sharding rules: ROADMAP queue 1, item 7, "Sharding"."""
