"""End-to-end data integrity, checksummed frames verified at consume: the
port of ``tpu_sgd/io/integrity.py`` (copied whole).

* :func:`seal` computes a CRC-32 over a frame's host bytes (dtype and
  shape included, so a truncated frame can never alias a shorter valid
  one) at the PRODUCE site;
* :func:`verify` recomputes it at the CONSUME site, and a mismatch
  raises the typed :class:`IntegrityError` and bumps the
  ``integrity.corrupt`` / ``integrity.corrupt.<site>`` counters.

:class:`IntegrityError` subclasses ``RuntimeError`` on purpose: the
default :class:`~tpu_sgd_torch.reliability.retry.RetryPolicy` retries
it, and every producer is deterministic in ``(seed, iteration)``, so a
healed retry reproduces the frame bit for bit.
``CheckpointManager.restore``'s latest-default path instead quarantines
the proven-bad file and falls back to an older one
(``tpu_sgd_torch/utils/checkpoint.py``).  Checksums are host work over
bytes the producers already hold: no kernel launch and no host sync.
"""

from __future__ import annotations

import zlib
from typing import Optional

import numpy as np

from tpu_sgd_torch.obs.counters import inc
from tpu_sgd_torch.obs.spans import event

#: lock-discipline declaration (the JAX package's analyzer reads these): EMPTY on
#: purpose.  The only mutable module state is the ``_ENABLED`` bool —
#: a GIL-atomic reference flip read by hot paths and written only by
#: test harnesses (the failpoints/obs gate idiom).
GRAFTLINT_LOCKS: dict = {}

#: fast-path gate: :func:`seal` reads this ONE module global and
#: returns None when falsy — frames then carry no checksum and
#: :func:`verify` skips (``expected is None``).  Default ON: the
#: checksum is host CRC-32 over bytes the producer already assembled.
_ENABLED = True


class IntegrityError(RuntimeError):
    """A frame failed its integrity check at ``site``.

    ``kind`` names the check that failed (``"checksum"`` today;
    ``"poison"`` is spelled as a typed ``PushResult.poisoned`` at the
    store's admission guard instead — a rejected push is a protocol
    answer, not an unwind).  Subclasses ``RuntimeError`` so the default
    ``RetryPolicy`` treats it as transient: the producers are
    deterministic in ``(seed, iteration)``, so the healing retry
    replays the exact frame and the healed run is bitwise the
    fault-free one."""

    def __init__(self, site: str, kind: str = "checksum",
                 detail: str = ""):
        self.site = site
        self.kind = kind
        msg = f"integrity violation at {site!r} ({kind})"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


def set_integrity(enabled: bool) -> None:
    """Bench/test switch for the checksummed-wire plane (see module
    docstring).  The poison-admission guard and the rollback controller
    are NOT gated here."""
    global _ENABLED
    _ENABLED = bool(enabled)


def integrity_enabled() -> bool:
    return _ENABLED


def checksum_arrays(*arrays) -> int:
    """CRC-32 over the concatenated ``(dtype, shape, bytes)`` of every
    array (None leaves hash a sentinel so positional structure is
    covered too).  Dtype and shape ride the digest ON PURPOSE: a
    truncated frame must fail even when its surviving bytes are intact,
    and a bf16 frame must never verify against its f32 twin."""
    c = 0
    for a in arrays:
        if a is None:
            c = zlib.crc32(b"<none>", c)
            continue
        a = np.ascontiguousarray(a)
        c = zlib.crc32(repr((a.dtype.str, a.shape)).encode(), c)
        try:
            c = zlib.crc32(a.data, c)  # zero-copy buffer view
        except (ValueError, BufferError):
            # extension dtypes (ml_dtypes bf16) refuse the buffer
            # protocol: digest their raw bytes instead (one copy)
            c = zlib.crc32(a.tobytes(), c)
    return c


def seal(*arrays) -> Optional[int]:
    """Produce-site checksum of a frame, or None when the integrity
    plane is disabled (an A/B arm) — a None seal makes the
    matching :func:`verify` a no-op, so the two sides always agree on
    whether the wire is checksummed."""
    if not _ENABLED:
        return None
    return checksum_arrays(*arrays)


def verify(site: str, expected: Optional[int], *arrays) -> None:
    """Consume-site check: recompute the frame's checksum and compare.

    A mismatch is a DETECTED corruption: the ``integrity.corrupt`` /
    ``integrity.corrupt.<site>`` counters bump (the window series the
    ``IntegrityDetector`` trips on), one typed ``integrity.corrupt_frame``
    event lands on the trace, and the typed :class:`IntegrityError`
    raises for the site's retry machinery to heal.  ``expected=None``
    (unsealed frame — integrity disabled, or a legacy producer) skips.
    """
    if expected is None:
        return
    actual = checksum_arrays(*arrays)
    if actual != expected:
        inc("integrity.corrupt")
        inc(f"integrity.corrupt.{site}")
        event("integrity.corrupt_frame", site=site, kind="checksum")
        raise IntegrityError(
            site, "checksum",
            f"crc {actual:#010x} != sealed {expected:#010x}")
    inc(f"integrity.verified.{site}")
