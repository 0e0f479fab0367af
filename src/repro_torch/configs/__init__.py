"""Architecture configurations (the LM family)."""
