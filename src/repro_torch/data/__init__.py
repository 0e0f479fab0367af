"""Synthetic data pipelines (numpy, host side): LM tokens, GNN batches and
the fanout sampler, DIN click logs."""
