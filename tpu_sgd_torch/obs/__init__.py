"""Observability of the port: span tracing (``obs/spans.py``), the
counter registry (``obs/counters.py``), the windowed time series
(``obs/timeseries.py``) and the flight recorder (``obs/flightrec.py``).
The JAX package's detectors, reports and ``enable`` facade wait for
ROADMAP A11's rest (``obs/detect.py`` first); until then switch each
layer on by itself (``spans.enable_tracing``, ``counters.enable``,
``timeseries.enable``, ``flightrec.enable`` with a ``TeeSink``)."""

from tpu_sgd_torch.obs import flightrec
from tpu_sgd_torch.obs.flightrec import FlightRecorder, TeeSink

__all__ = ["flightrec", "FlightRecorder", "TeeSink"]
