"""Data pipelines of the port: ``lm`` (the deterministic synthetic LM
stream)."""
