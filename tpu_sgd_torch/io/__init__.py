"""Data-integrity frames (``io/integrity.py``).  The ingest pipeline of
the JAX package's ``io/`` waits for ROADMAP A9."""
