"""Architecture configurations (the LM, GNN and recsys families)."""
