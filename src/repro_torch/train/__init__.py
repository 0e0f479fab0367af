"""Training of the LM family (PyTorch): AdamW by hand, the train step with
microbatch accumulation, checkpoints in the reference's format (the elastic
restore onto any mesh), the fault-tolerant controller, and the GPipe
pipeline over the pod axis (``train/pipeline.py``)."""
