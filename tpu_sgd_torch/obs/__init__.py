"""Observability of the port: span tracing (``obs/spans.py``) and the
counter registry (``obs/counters.py``).  The JAX package's time series,
detectors, flight recorder and runtime patches wait for ROADMAP A11."""
