"""Checkpoints of the port: ``manager`` (atomic, keep-k, resume-latest, the
reference's on-disk format)."""
