"""Observability of the port: span tracing (``obs/spans.py``), the
counter registry (``obs/counters.py``) and the windowed time series
(``obs/timeseries.py``).  The JAX package's detectors, flight recorder,
reports and runtime patches wait for ROADMAP A11."""
