"""Optimizer-state checkpoint and resume: the port of
``tpu_sgd/utils/checkpoint.py`` (numpy only, copied whole).

The full optimizer state ``(weights, iteration, reg_val, loss_history)``
is saved every K steps in the JAX package's npz format and
``FORMAT_VERSION``, so a checkpoint that either package writes restores
in the other.  Each iteration is deterministic in ``(seed, iteration)``,
so a resumed run replays the uninterrupted one.
"""

from __future__ import annotations

import functools
import glob
import io
import logging
import os
import re
import zipfile
from typing import Callable, Optional

import numpy as np

from tpu_sgd_torch.io.integrity import (IntegrityError, checksum_arrays,
                                  integrity_enabled)
from tpu_sgd_torch.reliability.failpoints import FaultInjected, failpoint

logger = logging.getLogger("tpu_sgd_torch_torch.checkpoint")


def _content_checksum(entries: dict) -> int:
    """CRC-32 over every npz entry's name and bytes, in sorted-name
    order — ONE definition shared by :meth:`CheckpointManager.save`
    (sealing) and :meth:`CheckpointManager._parse` (verifying), so a
    flipped bit, a truncated array, or a silently dropped field in ANY
    entry fails the restore-time check."""
    leaves = []
    for k in sorted(entries):
        leaves.append(np.frombuffer(k.encode(), np.uint8))
        leaves.append(np.asarray(entries[k]))
    return checksum_arrays(*leaves)

FORMAT_VERSION = "1.0"

#: checkpoint file names: the legacy ``ckpt_<iteration>.npz`` (epoch 0)
#: and the failover-stamped ``ckpt_e<epoch>_<iteration>.npz`` — the
#: JAX package's replicated store saves under the epoch of
#: its failover generation, and ordering/restore prefer the highest
#: ``(epoch, iteration)``, so a fenced old primary's late save can
#: never shadow the promoted store's state.
_CKPT_NAME = re.compile(r"^ckpt_(?:e(?P<epoch>\d+)_)?(?P<iter>\d+)\.npz$")


class CheckpointVersionError(ValueError):
    """The checkpoint is intact but from an incompatible format version —
    a real incompatibility, never skipped by the corruption fallback."""


@functools.lru_cache(maxsize=1024)
def _npy_header(major: int, header: bytes):
    """``(dtype, shape, fortran_order)`` of an ``.npy`` header: a run
    writes a handful of distinct headers, so each is parsed once a
    process rather than once a read (numpy parses it with
    ``ast.literal_eval``, the dearest part of a small restore)."""
    fp = io.BytesIO(len(header).to_bytes(2 if major == 1 else 4, "little")
                    + header)
    read = (np.lib.format.read_array_header_1_0 if major == 1
            else np.lib.format.read_array_header_2_0)
    shape, fortran_order, dtype = read(fp)
    return dtype, shape, fortran_order


def _npy_array(data: bytes) -> np.ndarray:
    """One ``.npy`` member, as ``np.load(..., allow_pickle=False)`` reads
    it (a writable copy)."""
    major = data[6]
    if major not in (1, 2):
        return np.lib.format.read_array(io.BytesIO(data), allow_pickle=False)
    width = 2 if major == 1 else 4
    size = int.from_bytes(data[8:8 + width], "little")
    start = 8 + width
    dtype, shape, fortran_order = _npy_header(major, data[start:start + size])
    if dtype.hasobject:
        raise ValueError("Object arrays cannot be loaded when "
                         "allow_pickle=False")
    count = int(np.prod(shape, dtype=np.int64))
    arr = np.frombuffer(data, dtype, count, offset=start + size)
    if fortran_order:
        return arr.reshape(shape[::-1]).T.copy(order="F")
    return arr.reshape(shape).copy()


def _npz_arrays(blob: bytes) -> dict:
    """Every member of the ``.npz`` file held in ``blob``, by name, as
    ``np.load(..., allow_pickle=False)`` gives them (an array, or the raw
    bytes of a member that is not an ``.npy``): one parse of each member,
    where a restore through ``np.load`` re-reads a member on every
    lookup."""
    out = {}
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        for name in zf.namelist():
            data = zf.read(name)
            key = name[:-4] if name.endswith(".npy") else name
            out[key] = (_npy_array(data)
                        if data.startswith(np.lib.format.MAGIC_PREFIX)
                        else data)
    return out


class CheckpointManager:
    """Numbered npz checkpoints in a directory, pruned to ``keep`` newest.

    ``on_corruption(path, quarantined_path, error)`` (optional) fires
    whenever the latest-default :meth:`restore` skips an unreadable
    checkpoint — the hook an ops pipeline uses to page on silent data
    loss instead of discovering it in a post-mortem (wire it to a
    ``ReliabilityEvent`` on your event log)."""

    def __init__(self, directory: str, keep: int = 3,
                 on_corruption: Optional[Callable] = None):
        self.directory = directory
        self.keep = keep
        self.on_corruption = on_corruption
        os.makedirs(directory, exist_ok=True)
        # a crash mid-save leaves .tmp_ckpt_* orphans (invisible to the
        # ckpt_*.npz glob but full model-sized files); sweep the STALE
        # ones here so a flaky job cannot leak disk indefinitely — but
        # only files old enough that no live writer (another process
        # sharing this directory, mid-save) can plausibly own them
        import time as _time

        cutoff = _time.time() - 3600
        for stale in glob.glob(os.path.join(directory, ".tmp_ckpt_*.npz")):
            try:
                if os.path.getmtime(stale) < cutoff:
                    os.remove(stale)
            except OSError:
                pass
        # quarantined corrupt files (.bad_ckpt_*, restore()'s fallback)
        # are kept for forensics but BOUNDED — a flaky job must not leak
        # one model-sized file per torn checkpoint forever
        def _mtime(p):
            try:
                return os.path.getmtime(p)
            except OSError:
                return 0.0  # vanished concurrently: sorts first, skipped

        bad = sorted(glob.glob(os.path.join(directory, ".bad_ckpt_*.npz")),
                     key=_mtime)
        for p in bad[:-max(1, keep)]:
            try:
                os.remove(p)
            except OSError:
                pass

    def _path(self, iteration: int, epoch: int = 0) -> str:
        if epoch:
            return os.path.join(
                self.directory, f"ckpt_e{epoch:04d}_{iteration:08d}.npz")
        return os.path.join(self.directory, f"ckpt_{iteration:08d}.npz")

    @staticmethod
    def _key_of(path: str):
        """Parsed ``(epoch, iteration)``, or None for a hand-named
        ckpt_*.npz file (e.g. a user's 'ckpt_best.npz' copy) — those
        are ignored rather than crashing every save/restore in the
        directory."""
        m = _CKPT_NAME.match(os.path.basename(path))
        if m is None:
            return None
        return (int(m.group("epoch") or 0), int(m.group("iter")))

    @staticmethod
    def _iteration_of(path: str):
        key = CheckpointManager._key_of(path)
        return None if key is None else key[1]

    def _paths_by_iteration(self):
        # sort by the PARSED (epoch, iteration), not lexicographically:
        # at iteration 10^8 the name grows a digit and 'ckpt_100000000'
        # sorts before 'ckpt_99999999', which would make latest_path
        # return stale state and _prune delete every NEW checkpoint.
        # Epoch is the MAJOR key: after a store failover, the promoted
        # epoch's saves outrank a fenced old primary's late save even
        # when that save carries a higher iteration number.
        paths = glob.glob(os.path.join(self.directory, "ckpt_*.npz"))
        numbered = [p for p in paths if self._key_of(p) is not None]
        return sorted(numbered, key=self._key_of)

    def save(
        self,
        iteration: int,
        weights,
        reg_val: float,
        loss_history,
        config_key: str = "",
        extras: Optional[dict] = None,
        epoch: int = 0,
    ) -> str:
        """``extras``: optional named arrays saved alongside the core
        state (``x_``-prefixed in the npz so they can never collide with
        the versioned schema) — the streaming driver persists its
        ``intercept`` through this (its stream position rides the core
        ``iteration`` field).  ``epoch``: the store failover generation
        of the JAX package's replicated store; stamped into the file NAME so
        ordering and :meth:`restore` prefer the highest ``(epoch,
        iteration)`` without opening every file."""
        from tpu_sgd_torch.obs.spans import span

        # the span's ``iteration`` attr is the join key obs.report's
        # served-weight staleness metric uses: reload ts minus the ts of
        # the checkpoint.save span that wrote that version
        with span("checkpoint.save", iteration=int(iteration)):
            failpoint("checkpoint.save")  # injected BEFORE any byte is
            # written: a save fault never leaves a partial file behind
            path = self._path(iteration, epoch)
            # Temp prefix must NOT match the ckpt_*.npz glob, or a
            # truncated file left by a crash mid-write would be picked
            # up by latest_path.
            tmp = os.path.join(self.directory,
                               ".tmp_" + os.path.basename(path))
            entries = {
                "version": np.asarray(FORMAT_VERSION),
                "iteration": np.asarray(iteration, np.int64),
                "epoch": np.asarray(epoch, np.int64),
                "weights": np.asarray(weights),
                "reg_val": np.asarray(reg_val, np.float64),
                "loss_history": np.asarray(loss_history, np.float64),
                "config_key": np.asarray(config_key),
                **{f"x_{k}": np.asarray(v)
                   for k, v in (extras or {}).items()},
            }
            if integrity_enabled():
                # content checksum over every entry:
                # verified at restore, so a bit flipped at rest — in
                # bytes npz's own zip CRC does not cover end-to-end, or
                # after a tool rewrote the archive — is a typed,
                # quarantined corruption instead of poisoned weights
                entries["checksum"] = np.asarray(
                    _content_checksum(entries), np.uint32)
            with open(tmp, "wb") as f:
                np.savez(f, **entries)
                # fsync BEFORE the rename: os.replace is atomic for the
                # directory entry, but on a writeback mount a power loss
                # can journal the rename while the data blocks are still
                # dirty — a durable name pointing at truncated bytes
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            self._prune()
            return path

    def _prune(self):
        for p in self._paths_by_iteration()[: -self.keep]:
            os.remove(p)

    def latest_path(self) -> Optional[str]:
        paths = self._paths_by_iteration()
        return paths[-1] if paths else None

    def versions(self):
        """Retained checkpoint iterations in ``(epoch, iteration)``
        order, deduplicated — the serving registry's load-by-version
        surface (serve/registry.py).  After a store failover the list
        may be non-monotone in the iteration number alone: the promoted
        epoch's saves rank last (= newest) even when a fenced old
        primary left a higher-numbered save behind."""
        out, seen = [], set()
        for p in self._paths_by_iteration():
            it = self._iteration_of(p)
            if it not in seen:
                seen.add(it)
                out.append(it)
        return out

    def latest_version(self) -> Optional[int]:
        p = self.latest_path()
        return None if p is None else self._iteration_of(p)

    def restore_version(self, iteration: int) -> dict:
        """Load exactly the checkpoint written at ``iteration`` — the
        HIGHEST-epoch save of that iteration when a failover wrote it
        twice (the fenced old primary's copy never wins).  Explicit
        version requests raise on a missing or corrupt file (the caller
        named a specific version, so silently serving another would be
        wrong) — the latest-default :meth:`restore` keeps its fallback."""
        matches = [p for p in self._paths_by_iteration()
                   if self._iteration_of(p) == int(iteration)]
        if not matches:
            raise FileNotFoundError(
                f"no checkpoint for iteration {iteration} in "
                f"{self.directory!r} (retained: {self.versions()})"
            )
        return self._load(matches[-1])

    def restore(self, path: Optional[str] = None) -> Optional[dict]:
        """Load a checkpoint dict or ``None`` when the directory is empty.

        An explicitly requested ``path`` raises on corruption; the
        latest-checkpoint default FALLS BACK through the older retained
        checkpoints instead — ``keep > 1`` exists precisely so one
        torn/truncated newest file cannot permanently break resume."""
        if path is not None:
            return self._load(path)
        candidates = self._paths_by_iteration()
        for p in reversed(candidates):
            try:
                return self._load(p)
            except CheckpointVersionError:
                raise  # intact but incompatible: not corruption
            except (OSError, FaultInjected) as e:
                # transient I/O (EMFILE, NFS hiccup, vanished file) or an
                # injected chaos fault: NOT corruption — fall back to an
                # older checkpoint for THIS restore but leave the file in
                # place (same carve-out as serve/registry.maybe_reload;
                # quarantining here would let a one-off hiccup destroy a
                # finished run's final, fully valid checkpoint)
                logger.warning(
                    "checkpoint %s hit a transient I/O error (%s: %s); "
                    "falling back to the previous retained checkpoint "
                    "without quarantining", p, type(e).__name__, e)
            except Exception as e:  # truncated/torn file: try older
                # QUARANTINE the proven-bad file out of the numbered
                # namespace: left in place, _prune would keep treating
                # it as 'newest' and delete every VALID checkpoint the
                # resumed run writes below its iteration
                quarantined = os.path.join(
                    os.path.dirname(p), ".bad_" + os.path.basename(p))
                try:
                    os.replace(p, quarantined)
                except OSError:
                    quarantined = None  # left in place (e.g. perms)
                logger.warning(
                    "checkpoint %s unreadable (%s: %s); quarantined as %s, "
                    "falling back to the previous retained checkpoint", p,
                    type(e).__name__, e, quarantined or "<unmoved>")
                if self.on_corruption is not None:
                    try:
                        self.on_corruption(p, quarantined, e)
                    except Exception:  # observer must not break resume
                        logger.warning(
                            "on_corruption hook raised; continuing",
                            exc_info=True)
        return None

    @staticmethod
    def _load(path: str) -> dict:
        from tpu_sgd_torch.obs.spans import span

        with span("checkpoint.restore"):
            failpoint("checkpoint.load")
            return CheckpointManager._parse(path)

    @staticmethod
    def _parse(path: str) -> dict:
        # the file in one read and each member parsed once: a restore on
        # a serving thread (a tenant's admission) then gives up the
        # interpreter lock for two system calls, not one per member
        # read, and every hand-back costs a switch interval while other
        # threads run Python
        with open(path, "rb") as f:
            z = _npz_arrays(f.read())
        if str(z["version"]) != FORMAT_VERSION:
            raise CheckpointVersionError(
                f"unsupported checkpoint version {z['version']}"
            )
        if "checksum" in z:
            # the content-checksum verify.  Raising IntegrityError here
            # composes with restore()'s existing carve-outs: the
            # latest-default path QUARANTINES this file and falls back to
            # an older retained checkpoint (it is proven corrupt, not a
            # transient hiccup), explicit path/version requests raise to
            # the caller, and the serve registry marks the version bad.
            # Legacy checksum-less files load as before.
            expected = int(z["checksum"])
            actual = _content_checksum(
                {k: v for k, v in z.items() if k != "checksum"})
            if actual != expected:
                from tpu_sgd_torch.obs.counters import inc
                from tpu_sgd_torch.obs.spans import event

                inc("integrity.corrupt")
                inc("integrity.corrupt.checkpoint")
                event("integrity.corrupt_frame", site="checkpoint",
                      kind="checksum", path=path)
                raise IntegrityError(
                    "checkpoint", "checksum",
                    f"{path}: crc {actual:#010x} != sealed "
                    f"{expected:#010x}")
            from tpu_sgd_torch.obs.counters import inc

            inc("integrity.verified.checkpoint")
        return {
            "iteration": int(z["iteration"]),
            "epoch": (int(z["epoch"]) if "epoch" in z else 0),
            "weights": z["weights"],
            "reg_val": float(z["reg_val"]),
            "loss_history": z["loss_history"],
            "config_key": str(z["config_key"]),
            "extras": {k[2:]: v for k, v in z.items() if k.startswith("x_")},
        }
